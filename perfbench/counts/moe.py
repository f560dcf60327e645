"""The sparse mixture-of-experts layer of V-MoE (arXiv:2106.05974), served
dropless: T tokens of width D, each routed to its top k of E experts,
each expert an MLP D -> H -> D. Per layer:

- :func:`gemm_flops`: the routed expert products, ``4 k T D H`` (each of
  the k T rows through both of its expert's matrices, 2 operations a
  multiply-add), what kernel G1 computes whatever the routing;
- :func:`router_flops`: the router's ``2 T D E``;
- :func:`dispatch_bytes`: the least that the route and dispatch (kernel
  M1) moves: the tokens read once, the router's weight read once in f32,
  the k T dispatched rows written once, and the k T slots and gates (4
  bytes each) written once. The logits stay on chip;
- :func:`combine_bytes`: the least that the combine (kernel M2) moves: the
  k T expert outputs and the residual read once, the output written once,
  the slots and gates read once.

Rows and tokens in the configuration's dtype (``BYTES``)."""

from __future__ import annotations

BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}
INDEX = 4          # an int32 slot or an f32 gate


def gemm_flops(tokens: int, width: int, mlp: int, k: int) -> int:
    return 4 * k * tokens * width * mlp


def router_flops(tokens: int, width: int, experts: int) -> int:
    return 2 * tokens * width * experts


def dispatch_bytes(tokens: int, width: int, experts: int, k: int,
                   dtype: str) -> int:
    b = BYTES[dtype]
    return (tokens * width * b + experts * width * 4
            + k * tokens * width * b + 2 * k * tokens * INDEX)


def combine_bytes(tokens: int, width: int, k: int, dtype: str) -> int:
    b = BYTES[dtype]
    return (k * tokens * width * b + 2 * tokens * width * b
            + 2 * k * tokens * INDEX)


def call_shape(cfg: dict, traffic: dict) -> dict:
    """The shapes of a ``process_batch`` call's MoE layers from a
    configuration's ``regressor`` and a cell's traffic: every face slot of
    the call runs the regressor; tokens a layer, and the layers' count."""
    r = cfg["regressor"]
    faces = traffic["frames_per_call"] * cfg["max_faces"]
    return {"tokens": faces * ((r["crop"] // r["patch_size"]) ** 2 + 1),
            "width": r["hidden_size"], "mlp": r["mlp_dim"],
            "experts": r["num_experts"], "k": r["top_k"],
            "layers": len(r["moe_layers"]), "dtype": cfg["dtype"]}

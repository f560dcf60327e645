"""The port's scale-out on the CPU: the mesh, the distributed train step,
the tensor-parallel decode, the sharded loader and resident data, and the
dry run, as jobs of 2 and 4 processes joined over gloo.

Each job starts its ranks with ``parallel.launch.run_ranks`` (one intra-op
thread a rank, the rendezvous a file under ``tmp_path``, every child
killed after at most 120 s). The ranks run this module's ``*_rank``
functions; the module imports JAX only inside the parent's tests, so a
rank imports none (each checks). The JAX side runs in the parent, on the
conftest's virtual CPU devices:

- ``jit_train_step`` on a 2x1 and a 2x2 mesh (2 and 4 ranks, sync-BN)
  against JAX ``jit_train_step`` on ``make_mesh(n_data=2, n_model=1 or
  2)``: 2 SGD steps from the same carried-across weights on the same
  global batches, the head's dropout 0, the narrow MobileNetV2 of
  ``test_torch_train_step.py`` and its fp32 tolerance (per leaf, 5e-2 of
  the leaf's scale plus 10x the most JAX's own result moves when the
  batches move by one part in 1e7); the first step's losses within 1e-3;
  every rank's state bit for bit rank 0's. On the 2x2 mesh JAX's own
  result also moves with the mesh: its 2x2 program's first step does not
  leave the state bit for bit its 2x1 program's, and the second step's
  loss then differs from the 2x1 program's by 1.7e-5 of itself (the
  one-device program's by 1.4e-6), so there JAX's move is the larger of
  the nudge's and the 2x1 program's on the same batches;
- ``tp_dense_decode``'s slabs and checksums against JAX
  ``tp_dense_decode`` on the same meshes, rtol 1e-4 / atol 1e-3 (the
  dense decode's tolerance; the checksum sums 26,624 vertices, so atol
  1e-3 a vertex).
"""

import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from synergynet_tpu_torch.core import mesh as meshlib
from synergynet_tpu_torch.parallel.launch import run_ranks

torch.set_num_threads(2)

WIDTH = 0.35                                # test_torch_train_step.py's
SETTING = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 2, 2))
B = 8
LR = dict(base_lr=0.08, milestones=(2, 3), warmup=1, steps_per_epoch=2)
WD = 5e-4
STEPS = 2
DENSE = dict(rtol=1e-4, atol=1e-3)
JOB_TIMEOUT = 120


# -- the ranks (no JAX) --------------------------------------------------------

def train_rank(data: str, n_model: int) -> dict:
    """``jit_train_step`` on this rank's rows for each batch, then the TP
    decode of ``data``'s params."""
    assert "jax" not in sys.modules
    from synergynet_tpu_torch.convert import synergy_state_dict
    from synergynet_tpu_torch.mm3d import load_param_pack
    from synergynet_tpu_torch.nn.synergy import SynergyNet
    from synergynet_tpu_torch.parallel import (tp_dense_decode,
                                               warm_mesh_cliques)
    from synergynet_tpu_torch.train import (TrainState, jit_train_step,
                                            lr_per_step, make_optimizer)
    d = torch.load(data, weights_only=False)
    mesh = meshlib.make_mesh(n_model=n_model, device="cpu")
    warm_mesh_cliques(mesh)
    model = SynergyNet(dropout=0.0, width_mult=WIDTH, setting=SETTING)
    model.load_state_dict(synergy_state_dict(d["init"]))
    state = TrainState(model, WD)
    meshlib.replicate(mesh, state)
    pack = load_param_pack()
    step = jit_train_step(pack, make_optimizer(lr_per_step(**LR),
                                               weight_decay=WD), mesh)
    rows = meshlib.batch_sharding(mesh).local_slice(B)
    metrics = []
    for img, tgt in d["batches"]:
        _, m = step(state, *meshlib.shard_batch(mesh, (img[rows],
                                                       tgt[rows])))
        metrics.append({k: float(v) for k, v in m.items()})
    decode = tp_dense_decode(mesh, pack)
    slab, checksum = decode(torch.from_numpy(d["p62"][rows]))
    return {"tree": state.tree(), "flat": [t.clone() for t in
                                           state.tensors()],
            "metrics": metrics, "slab": slab, "checksum": checksum,
            "range": decode.vertex_range, "rows": (rows.start, rows.stop),
            "mesh": dict(mesh.shape), "jax": "jax" in sys.modules}


def sync_bn_rank() -> dict:
    """A BatchNorm over a data group: the output and the gradient of the
    input, each rank holding 3 of the 6 rows."""
    from synergynet_tpu_torch.nn.batchnorm import BatchNorm, sync_group
    mesh = meshlib.make_mesh(device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).normal(
        2, 3, (6, 4, 5, 5)).astype(np.float32))
    mine = x[3 * mesh.rank:3 * mesh.rank + 3].clone().requires_grad_()
    bn = BatchNorm(4)
    with torch.no_grad():
        bn.weight.copy_(torch.tensor([1.0, 2.0, -1.0, 0.5]))
    with sync_group(bn, mesh.data_group):
        y = bn(mine)
    (y * torch.arange(y.numel()).reshape(y.shape)).sum().backward()
    return {"y": y.detach(), "grad": mine.grad, "mean": bn.running_mean,
            "var": bn.running_var, "group_after": bn.group}


# -- the mesh on one process ---------------------------------------------------

def test_one_process_mesh_is_1x1_and_raises_as_jax():
    m = meshlib.make_mesh(device="cpu")
    assert m.shape == {"data": 1, "model": 1} and m.rank == 0
    assert m.data_group is None and m.model_group is None and not m.groups
    assert m.device == torch.device("cpu")
    with pytest.raises(ValueError, match="not divisible by n_model=2"):
        meshlib.make_mesh(n_model=2, device="cpu")
    with pytest.raises(ValueError, match="needs more than 1 devices"):
        meshlib.make_mesh(n_data=2, device="cpu")
    # descriptors: a fake rank at row 1, column 0 of a 2x2 grid
    fake = meshlib.Mesh(2, 2, 2, torch.device("cpu"))
    assert (fake.data_index, fake.model_index) == (1, 0)
    assert fake.data_ranks() == [0, 2] and fake.model_ranks() == [2, 3]
    assert meshlib.batch_sharding(fake).local_slice(8) == slice(4, 8)
    assert meshlib.vertex_sharding(fake).local_slice(10) == slice(0, 5)
    assert meshlib.replicated(fake).local_slice(8) == slice(0, 8)
    with pytest.raises(ValueError, match="not divisible"):
        meshlib.batch_sharding(fake).local_slice(7)
    x = np.arange(6, dtype=np.float32)
    got = meshlib.shard_batch(m, {"a": x, "b": [x]})
    assert torch.equal(got["b"][0], torch.from_numpy(x))
    assert meshlib.replicate(m, got) is got


def test_init_distributed_is_a_no_op_for_one_process():
    from synergynet_tpu_torch.parallel import (init_distributed,
                                               init_method)
    init_distributed(None, None, None)
    init_distributed("localhost:1", 1, 0)
    assert not meshlib.distributed()
    with pytest.raises(ValueError, match="process_id"):
        init_distributed("localhost:1", 2, None)
    with pytest.raises(ValueError, match="outside"):
        init_distributed("localhost:1", 2, 2)
    assert init_method("h:12") == "tcp://h:12"
    assert init_method("file:///x/y") == "file:///x/y"


def _narrow(seed=0):
    from synergynet_tpu_torch.nn.synergy import SynergyNet, init_synergy_
    model = SynergyNet(dropout=0.0, width_mult=WIDTH, setting=SETTING)
    return init_synergy_(model, torch.Generator().manual_seed(seed))


def test_step_on_a_1x1_mesh_is_make_train_step_bit_for_bit():
    from synergynet_tpu_torch.mm3d import load_param_pack
    from synergynet_tpu_torch.train import (TrainState, jit_train_step,
                                            make_optimizer, make_train_step)
    opt = make_optimizer(lambda c: 0.05, weight_decay=WD)
    pack = load_param_pack()
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.integers(0, 256, (4, 120, 120, 3), np.uint8))
    tgt = torch.from_numpy(rng.normal(0, 0.5, (4, 62)).astype(np.float32))
    states = []
    for step in (make_train_step(pack, opt, device="cpu"),
                 jit_train_step(pack, opt, meshlib.make_mesh(device="cpu"))):
        st = TrainState(_narrow(), WD)
        for _ in range(2):
            _, m = step(st, img, tgt)
        states.append((st.tensors(), {k: float(v) for k, v in m.items()}))
    (a, ma), (b, mb) = states
    assert all(torch.equal(x, y) for x, y in zip(a, b)) and ma == mb


def test_bn_groups_rejects_accum_steps_and_ragged_batches():
    from synergynet_tpu_torch.mm3d import load_param_pack
    from synergynet_tpu_torch.train import (TrainState, jit_train_step,
                                            make_optimizer, make_train_step)
    opt = make_optimizer(lambda c: 0.05)
    pack = load_param_pack()
    with pytest.raises(ValueError, match="mutually exclusive"):
        make_train_step(pack, opt, bn_groups=2, accum_steps=2, device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        jit_train_step(pack, opt, meshlib.make_mesh(device="cpu"),
                       bn_groups=2, accum_steps=2)
    step = make_train_step(pack, opt, bn_groups=3, device="cpu")
    st = TrainState(_narrow())
    with pytest.raises(ValueError, match="batch 4 not divisible into 3 BN "
                                         "groups"):
        step(st, torch.zeros(4, 120, 120, 3), torch.zeros(4, 62))
    fake = meshlib.Mesh(2, 1, 0, torch.device("cpu"))
    with pytest.raises(ValueError, match="bn_groups=3 must be 1 or a "
                                         "multiple"):
        jit_train_step(pack, opt, fake, bn_groups=3)


# -- the loader and resident data over data rows ------------------------------

class _Indices:
    transform = None

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, index, rng=None):
        return np.int64(index)


@pytest.mark.parametrize("n,rows,batch", [(50, 3, 4), (64, 2, 8)])
def test_loader_shards_are_disjoint_with_equal_lengths(n, rows, batch):
    from synergynet_tpu_torch.data import PrefetchLoader, shard_batches
    seen = []
    for row in range(rows):
        loader = PrefetchLoader(_Indices(n), batch, num_workers=2, seed=3,
                                process_index=row, process_count=rows)
        loader.set_epoch(2)
        got = [b.tolist() for b in loader]
        assert len(got) == len(loader) == (n // rows) // batch
        assert all(len(b) == batch for b in got)
        seen.append(sum(got, []))
    flat = sum(seen, [])
    assert len(flat) == len(set(flat)) and set(flat) <= set(range(n))
    # one process: the whole epoch, as before
    one = PrefetchLoader(_Indices(n), batch, num_workers=2, seed=3)
    one.set_epoch(2)
    order = sum((b.tolist() for b in one), [])
    assert len(order) == (n // batch) * batch
    assert seen[0] == order[0::rows][:len(seen[0])]
    mesh = meshlib.make_mesh(device="cpu")
    for b in shard_batches(one, mesh):
        assert isinstance(b, torch.Tensor) and b.shape == (batch,)
        break


def test_resident_rows_and_orders_per_data_row():
    from synergynet_tpu_torch.train import (shard_resident_arrays,
                                            shard_resident_params)
    from synergynet_tpu_torch.train.resident import (epoch_permutation,
                                                     generative_order)
    imgs = np.arange(7 * 2 * 2 * 3, dtype=np.uint8).reshape(7, 2, 2, 3)
    params = np.arange(7 * 62, dtype=np.float32).reshape(7, 62)
    for row in (0, 1):
        m = meshlib.Mesh(2, 1, row, torch.device("cpu"))
        gi, gt, hwc = shard_resident_arrays(m, imgs, params)
        assert hwc == (2, 2, 3) and gi.shape == (3, 2, 2, 3)
        assert np.array_equal(gi.numpy(), imgs[3 * row:3 * row + 3])
        assert np.array_equal(gt.numpy(), params[3 * row:3 * row + 3])
        assert np.array_equal(shard_resident_params(m, params).numpy(),
                              params[3 * row:3 * row + 3])
    one = meshlib.make_mesh(device="cpu")
    gi, gt, _ = shard_resident_arrays(one, imgs, params)
    assert np.array_equal(gi.numpy(), imgs)
    # row 0 draws as one process does; other rows draw their own
    p0 = epoch_permutation(0, 1, 32, "cpu")
    assert torch.equal(p0, epoch_permutation(0, 1, 32, "cpu", row=0))
    assert not torch.equal(p0, epoch_permutation(0, 1, 32, "cpu", row=1))
    want = np.random.default_rng(np.random.SeedSequence([0, 1])
                                 ).permutation(32)
    assert np.array_equal(generative_order(0, 1, 32), want)
    assert not np.array_equal(generative_order(0, 1, 32, row=1), want)


# -- gloo jobs -----------------------------------------------------------------

def test_sync_batchnorm_over_two_ranks_is_the_global_batch(tmp_path):
    """Two ranks of 3 rows each against one BatchNorm on all 6: output,
    input gradient (through the collective's backward) and running
    statistics."""
    from synergynet_tpu_torch.nn.batchnorm import BatchNorm
    ranks = run_ranks(f"{__name__}:sync_bn_rank", 2, str(tmp_path),
                      timeout=JOB_TIMEOUT)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        2, 3, (6, 4, 5, 5)).astype(np.float32)).requires_grad_()
    bn = BatchNorm(4)
    with torch.no_grad():
        bn.weight.copy_(torch.tensor([1.0, 2.0, -1.0, 0.5]))
    y = bn(x)
    w = torch.cat([torch.arange(75 * 4).reshape(3, 4, 5, 5)] * 2)
    (y * w).sum().backward()
    for r, got in enumerate(ranks):
        sl = slice(3 * r, 3 * r + 3)
        torch.testing.assert_close(got["y"], y[sl].detach(), rtol=1e-5,
                                   atol=1e-5)
        torch.testing.assert_close(got["grad"], x.grad[sl], rtol=1e-4,
                                   atol=1e-4)
        torch.testing.assert_close(got["mean"], bn.running_mean)
        torch.testing.assert_close(got["var"], bn.running_var)
        assert got["group_after"] is None


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        img = ((rng.integers(0, 256, (B, 120, 120, 3), np.uint8)
                .astype(np.float32) - 127.5) / 128.0)
        out.append((img, rng.normal(0, 0.5, (B, 62)).astype(np.float32)))
    return out


def _jax_model(monkeypatch):
    import synergynet_tpu.nn.synergy as jsyn
    from synergynet_tpu.nn.backbones.mobilenet_v2 import MobileNetV2
    monkeypatch.setattr(jsyn, "make_backbone", lambda arch, dtype:
                        MobileNetV2(width_mult=WIDTH, setting=SETTING,
                                    dropout=0.0, dtype=dtype))
    return jsyn.SynergyNet()


def _jax_runs(jm, jopt, jstate, n_model, batches, p62):
    """JAX ``jit_train_step`` over a 2 x n_model mesh of virtual CPU
    devices from ``jstate`` on ``batches`` and on the nudged batches, and
    JAX ``tp_dense_decode`` of ``p62``."""
    import jax
    from synergynet_tpu.core import make_mesh, replicate, shard_batch
    from synergynet_tpu.mm3d import load_param_pack as jax_load_pack
    from synergynet_tpu.parallel import tp_dense_decode
    from synergynet_tpu.train import step as jstep
    from tests.test_torch_train_step import _nudged
    mesh = make_mesh(n_data=2, n_model=n_model)
    pack = jax_load_pack()
    jfn = jstep.jit_train_step(jm, pack, jopt, mesh)
    runs = []
    layouts = [(mesh, jfn, batches), (mesh, jfn, _nudged(batches))]
    if n_model > 1:
        m21 = make_mesh(n_data=2, n_model=1)
        layouts.append((m21, jstep.jit_train_step(jm, pack, jopt, m21),
                        batches))
    for msh, fn, bs in layouts:
        st, met = replicate(msh, jstate), []
        for img, tgt in bs:
            st, m = fn(st, shard_batch(msh, img), shard_batch(msh, tgt),
                       jax.random.PRNGKey(1))
            met.append(jax.device_get(m))
        runs.append((jax.device_get(st), met))
    out, checksum = tp_dense_decode(mesh, pack)(shard_batch(mesh, p62))
    return runs, (np.asarray(out), np.asarray(checksum))


def _widest(want, *others):
    """Per leaf, whichever of ``others`` lies furthest from ``want``: JAX's
    largest own move."""
    from tests.test_torch_train_step import _leaves
    w = dict(_leaves(want))
    trees = [dict(_leaves(o)) for o in others]
    return {k: max((t[k] for t in trees),
                   key=lambda x: float(np.abs(x - w[k]).max()))
            for k in w}


@pytest.mark.parametrize("n_model", [1, 2])
def test_gloo_jit_train_step_and_tp_decode_match_jax(tmp_path, monkeypatch,
                                                     n_model):
    import jax
    from synergynet_tpu.train import step as jstep
    from tests.test_torch_train_step import (B as TB, LR as TLR,
                                             SETTING as TSET, WD as TWD,
                                             WIDTH as TW, _check_metrics,
                                             _optimizers, assert_close_rel,
                                             minus)
    assert (TB, TLR, TSET, TWD, TW) == (B, LR, SETTING, WD, WIDTH)
    jopt, _ = _optimizers()
    jm = _jax_model(monkeypatch)
    jstate = jax.device_get(jstep.create_train_state(
        jm, jax.random.PRNGKey(0), jopt))
    init = {"params": jstate.params, "batch_stats": jstate.batch_stats}
    batches = _batches(STEPS)
    p62 = np.random.default_rng(5).normal(0, 1, (B, 62)).astype(np.float32)
    data = str(tmp_path / "data.pt")
    torch.save({"init": init, "batches": batches, "p62": p62}, data)
    world = 2 * n_model
    # the ranks run while JAX compiles
    with ThreadPoolExecutor(1) as pool:
        job = pool.submit(run_ranks, f"{__name__}:train_rank", world,
                          str(tmp_path / "job"),
                          {"data": data, "n_model": n_model},
                          timeout=JOB_TIMEOUT)
        runs, (jout, jck) = _jax_runs(jm, jopt, jstate, n_model, batches,
                                      p62)
        ranks = job.result()
    (jend, jmet), *moved = runs
    moved = [st for st, _ in moved]
    assert [r["mesh"] for r in ranks] == [{"data": 2, "model": n_model}] * \
        world and not any(r["jax"] for r in ranks)
    for r in ranks[1:]:                  # one state on every rank
        assert all(torch.equal(a, b) for a, b in zip(r["flat"],
                                                     ranks[0]["flat"]))
    tree = ranks[0]["tree"]
    assert int(tree["step"]) == int(jend.step) == STEPS
    assert int(tree["opt_state"]["2"]["count"]) == int(
        jend.opt_state[2].count)
    rel = 5e-2
    upd = minus(jend.params, init["params"])
    assert_close_rel(minus(tree["params"], init["params"]), upd, rel,
                     "update", _widest(upd, *(minus(o.params, init["params"])
                                              for o in moved)))
    assert_close_rel(tree["opt_state"]["1"]["trace"],
                     jend.opt_state[1].trace, rel, "trace",
                     _widest(jend.opt_state[1].trace,
                             *(o.opt_state[1].trace for o in moved)))
    assert_close_rel(tree["batch_stats"], jend.batch_stats, rel,
                     "batch_stats", _widest(jend.batch_stats,
                                            *(o.batch_stats for o in moved)))
    for r in ranks:
        _check_metrics(jmet[:1], r["metrics"][:1])
        assert all(m["skipped"] == 0.0 for m in r["metrics"])
        lo, hi = r["range"]
        rows = slice(*r["rows"])
        assert hi - lo == jout.shape[2] // n_model
        np.testing.assert_allclose(r["slab"].numpy(), jout[rows, :, lo:hi],
                                   **DENSE)
        np.testing.assert_allclose(r["checksum"].numpy(), jck[rows],
                                   rtol=1e-4, atol=1e-3 * (hi - lo))


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_holds_the_ranks_to_one_process(tmp_path, n):
    """The port's dry run on the CPU: the per-replica step, the TP decode,
    sharded serving and a generative epoch on n ranks, each held against
    one process (it raises past its tolerances)."""
    from synergynet_tpu_torch.parallel.dryrun import (STATE_REL,
                                                      dryrun_multichip)
    r = dryrun_multichip(n, device="cpu", timeout=JOB_TIMEOUT,
                         workdir=str(tmp_path))
    assert r["mesh"] == ({"data": 2, "model": 1} if n == 2
                         else {"data": 2, "model": 2})
    assert r["backend"] == "gloo" and r["world"] == n
    assert max(r["step_rel"].values()) <= STATE_REL
    assert max(r["gen_rel"].values()) <= STATE_REL
    assert r["serve_faces"] > 0 and np.isfinite(r["gen_loss"])
    assert r["tp_max_abs_err"] <= 1e-3

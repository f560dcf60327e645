"""The busiest expert's rows over the mean rows an expert, averaged over
the mixture-of-experts layers of every call in the run: the program's
tallies ``moe_rows_max`` (each MoE layer's busiest expert's rows, summed
over layers and calls) over ``moe_rows`` (the rows routed, likewise) over
the configuration's ``num_experts``. 1 is a perfectly balanced routing, E
one expert taking every row. The tallies are written on the device by the
route and dispatch kernel from its histogram; the reading assumes a
dropless layer, where every layer routes the same k T rows, so the ratio
of the sums is the mean of the layers' ratios. A program that tallies no
routing reads nothing."""

from perfbench.stages import batch_key, recorder


def read(rec):
    r, key = recorder(), batch_key(rec)
    if r is None or key is None:
        return None
    c = r.counters(key)
    if not c or not c.get("moe_rows") or "moe_rows_max" not in c:
        return None
    return c["moe_rows_max"] / (c["moe_rows"]
                                / rec.cfg["regressor"]["num_experts"])

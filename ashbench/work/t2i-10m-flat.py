"""The work of the t2i-10m-flat searches: prep, the dense scan with
its selection of the rerank shortlist (kernel 2 and its merge), and the
exact rerank of that shortlist from the bf16 copy."""
from ashbench import yardstick as Y


def traced(rec, plan, blocks):
    """The work of the traced stretch: its batch calls (``blocks``, one
    pool block a call), or the engine's fused calls and rows."""
    cfg, s = rec.config, Y.shapes(rec.config)
    metric, short = cfg["metric"], max(plan.rerank, plan.k)
    if blocks is not None:
        calls, rows = len(blocks), len(blocks) * plan.rows_per_call
    else:
        calls, rows = rec.traced_counters["batches"], \
            rec.traced_counters["rows"]
    scan = Y.dense_scan(rows, s["n"], s["d_pad"], s["words"], s["C"], short,
                        metric)
    # every fused call reads the payload once
    scan.bytes += max(calls - 1, 0) * s["n"] * Y.row_bytes(s["words"])
    return (Y.prep(rows, s["D"], cfg["ash"]["d"], s["C"]) + scan
            + Y.rerank(rows, short, s["D"], plan.k, metric))

"""The work of the deep-10m-ivf searches: prep, the gathered scan of
the live candidates of each query's probed lists with its selection of
the rerank shortlist (kernel 4 and its merge), and the exact rerank.
The lists a query probes and their live rows are the system's own
counters (``probe_sets``, ``list_sizes``).  Only batch cells run this
configuration."""
import numpy as np

from ashbench import yardstick as Y


def traced(rec, plan, blocks):
    """The work of the traced stretch's batch calls (``blocks``, one
    pool block a call, each reading the distinct rows of its queries'
    probed lists once)."""
    cfg, s = rec.config, Y.shapes(rec.config)
    metric, short = cfg["metric"], max(plan.rerank, plan.k)
    sizes, per = rec.list_sizes, plan.rows_per_call
    w = Y.Work()
    for b in blocks:
        probe = rec.probes[b * per:(b + 1) * per]
        w = w + Y.gather_scan(per, float(sizes[probe].sum()),
                              float(sizes[np.unique(probe)].sum()),
                              s["d_pad"], s["words"], s["C"], short, metric)
    rows = len(blocks) * per
    return (w + Y.prep(rows, s["D"], cfg["ash"]["d"], s["C"])
            + Y.rerank(rows, short, s["D"], plan.k, metric))

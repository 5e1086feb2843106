"""The hop kernels' share of their roofline, in %, over a sample of the
traced window's batches drawn from the seed.

Device time: every kernel of a counted batch whose name holds one of
``HOP_KERNELS`` (the port's hop kernels and the row-chunk epilogue of its
batched hop). Bound of a batch: Σ over the query's hops of
max(bytes / HBM rate, operations / float32 rate), counted from the
reference's frontiers for the batch's own bindings, whatever kernel or
encoding the program uses:

* bytes: every edge of a source live in any row, each column the hop reads
  (the other key, and the measure where the query weighs by one) at the
  fixed width its count of distinct values needs; the B rows of the frontier
  read once and of the output written once, at 4 B a value;
* operations: an add for every edge of a live source in each row where it
  is live, and a multiply where the hop has a measure.
"""
import torch

from gqbench import reference as R

HOP_KERNELS = ("fragment_spmv", "fragment_spmm", "rows_from_chunks")


def hop_bound_s(h, graph, peaks):
    bits = graph.width_bits(h["table"], h["dst_col"])
    if h["measure"] is not None:
        bits += graph.width_bits(h["table"], h["measure"])
    nbytes = h["E_union"] * bits / 8 + h["B"] * (h["n_src"] + h["n_dst"]) * 4
    ops = h["E_rows"] * (2 if h["measure"] is not None else 1)
    return max(nbytes / peaks["hbm_bytes_per_s"], ops / peaks["fp32_flops_per_s"])


def read(ctx):
    tr = ctx.trace
    if tr is None or ctx.peaks is None or not ctx.counted_batches:
        return None
    if len(tr.batches) != len(ctx.batch_log):
        raise RuntimeError(f"{len(tr.batches)} traced batches against {len(ctx.batch_log)} run")
    bound = busy = 0.0
    for i in ctx.counted_batches:
        hop_s = sum(e[1] for e in tr.batch_device[i]
                    if e[2] == "kernel" and any(k in e[3] for k in HOP_KERNELS)) / 1e6
        if hop_s <= 0:
            continue
        shape, batch = ctx.batch_log[i]
        params = ctx.stream.arrays(batch)
        work = []
        R.query(shape).run(ctx.graph, params, torch.float64, work=work)
        bound += sum(hop_bound_s(h, ctx.graph, ctx.peaks) for h in work)
        busy += hop_s
    return 100.0 * bound / busy if busy > 0 else None

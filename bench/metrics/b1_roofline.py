"""Kernel B1's share of its roofline over the traced span, in percent: the
least time its calls there need (K and V of the attended positions, q and
the output, each moved once, against HBM's bandwidth; or their FLOPs
against the bf16 peak, if larger) over B1's summed kernel time in the
profiler's trace.  Nothing to read where the trace holds no B1 kernel or
another number of B1 calls than the traced steps make."""

from bench import flops


def read(run):
    if not run.trace or not run.trace["b1_s"]:
        return None
    calls, least = 0, 0.0
    for s in run.traced:
        n, t = flops.b1_batch(run.spec, s.batch.tokens.shape[0], s.batch.prompt, s.batch.steps)
        calls, least = calls + n, least + t
    if calls != run.trace["b1_calls"]:
        return None
    return least / run.trace["b1_s"] * 100

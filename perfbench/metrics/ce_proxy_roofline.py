"""Kernel ``ce_proxy`` (``kernels/ops.py`` → ``csrc/ce_proxy.cu``): the
least time its launches in the traced window could take (4·T·D·V at the
bf16 peak, or its bytes at 3.35 TB/s; ``perfbench/counts.py``) over their
device time by name in the trace, in %.  Nothing when the trace holds no
such kernel."""

from perfbench.counts import ce_proxy_bound_s


def read(run):
    if run.trace is None:
        return None
    seconds, n = run.trace.time_of("ce_proxy")
    if n == 0 or seconds <= 0:
        return None
    s = run.shape
    bound, _ = ce_proxy_bound_s(run.tokens_per_step, s.d_model, s.vocab_size, 2,
                                run.peaks["bf16_flops"], run.peaks["hbm_bytes"])
    return 100.0 * n * bound / seconds

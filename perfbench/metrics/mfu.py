"""The whole step's share of the bf16 peak: the model FLOPs the window's
work needs (``perfbench/counts.py``: train steps, refresh forwards and the
proxy head), over the window's seconds times 989 TFLOP/s."""


def read(run):
    if not run.model_flops:
        return None
    return 100.0 * run.model_flops / (run.window_s * run.peaks["bf16_flops"])

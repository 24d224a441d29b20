"""Tokens of every training step completed in the window, over the window's
seconds (install waits included).  Host clock."""


def read(run):
    return len(run.steps) * run.tokens_per_step / run.window_s

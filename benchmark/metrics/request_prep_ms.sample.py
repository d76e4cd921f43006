"""Layer: the pipeline's work for a request before its first step (``pipelines/cogvideox.py``
``__call__``): the checks and plans, the VAE encode of the conditioning frame and its posterior
draw, the scaling and padding, the scheduler's and ALG's plans and the RoPE tables. Milliseconds
from the pipeline call's start to its first DiT forward's start, once a request."""


def read(view):
    if not view.forwards:
        return None
    return (view.forwards[0]["start"] - view.call_start) / 1e3

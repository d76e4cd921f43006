"""Layer: the pipeline's step loop (``pipelines/denoise.py``, ``alg/``'s filter,
``schedulers/ddim_cogvideox.py``, the CFG combine in ``pipelines/cogvideox.py``). Milliseconds a
denoise step spends outside the DiT forward: from the first DiT forward's start to the last step's
end, less the DiT forwards' ranges (each opened and closed after a synchronise), over the steps
completed. It holds the ALG filter, the CFG combine, the DDIM update, the observer's copy of the
latents and the loop; the call's work before its first step (``request_prep_ms.sample``) is not in it."""


def read(view):
    if not view.forwards or view.steps == 0 or not view.step_ends:
        return None
    span = view.step_ends[-1] - view.forwards[0]["start"]
    inside = sum(f["end"] - f["start"] for f in view.forwards)
    return (span - inside) / view.steps / 1e3

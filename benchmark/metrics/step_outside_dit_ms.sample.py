"""Layer: the pipeline's step loop (``pipelines/denoise.py``, ``alg/``'s filter, the CFG combine in
``pipelines/cogvideox.py``, ``schedulers/ddim_cogvideox.py``), read from the program's own spans.
Milliseconds of a denoise step outside its DiT forward, on the device's clock: each ``denoise.step``
span's CUDA-event time less its ``dit.forward`` span's, averaged over the window's steps. It holds the ALG
filter, the CFG batch's concatenation and cast, the combine, the DDIM update, the observer's copy of the
latents and the device's waits for the host between them; no synchronise is added to the step."""

from benchmark import program_spans as ps


def read(view):
    records = ps.window_spans(view)
    if records is None or view.steps == 0:
        return None
    outside = {r["id"]: r["device_ms"] for r in records if r["name"] == ps.STEP}
    for r in records:
        if r["name"] == ps.FORWARD:
            step = ps.enclosing(records, r, ps.STEP)
            if step is None:
                return None
            outside[step["id"]] -= r["device_ms"]
    return sum(outside.values()) / len(outside)

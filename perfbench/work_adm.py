"""The ADM's res blocks' operations and bytes from their ``adm.res``
spans, and the reduction of the ADM's spans per U-Net item.

``res_work`` counts as ``work.k3_work`` does, for the block the ADM calls
(``models/adm_unet.py``'s ``ADMResBlock`` over ``ldm_unet.py``'s
``LDMResBlock``); ``work.bound`` turns it into the least time.
"""

from __future__ import annotations

from perfbench import program_spans


def res_work(shape, batch):
    """(tensor-core operations, float32 operations, bytes) of one ADM res
    block in bf16, ``shape`` = (h, w, cin, co, film, resample) at its
    input: both 3x3 convs at the resampled size h' x w' (a "down" block
    halves it, an "up" block doubles it), counting only the products by
    an input inside the image ((3h'-2)(3w'-2) (pixel, tap) pairs of 9h'w'),
    and the 1x1 skip where cin != co; on the CUDA cores the GroupNorm +
    SiLU before each conv (~12 operations an element with their
    statistics), the FiLM multiply-add (2) and the skip's add (1); x, the
    weights and the FiLM's scale and shift read once and the output
    written once.  The embedding's linear (its width is not in the shape)
    and the resampling's own traffic are left out, so the least time is a
    lower bound."""
    h, w, cin, co, film, resample = shape[:6]
    h2, w2 = (2 * h, 2 * w) if resample == "up" else (h // 2, w // 2) if resample == "down" else (h, w)
    m_in, m_out = batch * h * w, batch * h2 * w2
    taps = batch * (3 * h2 - 2) * (3 * w2 - 2)
    skip = cin != co
    macs = taps * (cin + co) * co + (m_out * cin * co if skip else 0)
    f32 = 12.0 * m_in * cin + (12.0 + (2.0 if film else 1.0) + 1.0) * m_out * co
    weights = 9 * cin * co + 9 * co * co + (cin * co if skip else 0)
    nbytes = 2 * (m_in * cin + m_out * co + weights + batch * co * (2 if film else 1) + 2 * cin + 6 * co)
    return 2.0 * macs, f32, float(nbytes)


def ms_per_unet_kitem(spans: list, name: str):
    """Device ms of the spans called ``name`` inside bf16 ``unet`` spans,
    per 1,000 items of those ``unet`` spans (not per block call): what
    the layer adds to a U-Net item.  None where no bf16 ``unet`` span
    holds one."""
    unets = {s["id"]: s for s in program_spans.named(spans, "unet", "bfloat16") if s["device_ms"] is not None}
    by_id = {s["id"]: s for s in spans}
    ms, holders = 0.0, set()
    for s in program_spans.named(spans, name):
        parent = by_id.get(s["parent"])
        while parent is not None and parent["id"] not in unets:
            parent = by_id.get(parent["parent"])
        if parent is not None and s["device_ms"] is not None:
            ms += s["device_ms"]
            holders.add(parent["id"])
    items = sum(unets[i]["attrs"]["items"] for i in holders)
    return 1000.0 * ms / items if items else None

"""``readback_ms``: device ms a batch of the copies from the card to the host
(``device.to_host``'s one transfer of the enhanced signals), from the
trace's device-to-host copies over the traced batches."""


def read(ctx):
    ms = [k.dur for k in ctx.trace.device if k.cat == "gpu_memcpy" and "DtoH" in k.name]
    if not ms:
        return None
    return sum(ms) / 1e3 / ctx.n_traced

"""``crnn_ms``: device ms a batch inside the CRNNs' forwards (the ``bench.crnn``
span the benchmark puts around each forward of both networks): convolutions,
BatchNorm, pooling, the GRU and the output layer."""


def read(ctx):
    ms = [k.dur for k in ctx.trace.device if k.cat == "kernel" and "bench.crnn" in k.spans]
    if not ms:
        return None
    return sum(ms) / 1e3 / ctx.n_traced

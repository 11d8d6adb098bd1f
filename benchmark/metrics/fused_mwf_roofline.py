"""``fused_mwf_roofline``: the fused rank-1 GEVD-MWF kernel's share of its
roofline (``csrc/mwf.cu`` through ``ops/mwf_ops.py``).  Over the traced
batches, the least time of every ``disco_torch::fused_mwf`` call
(``costs.mwf_flops`` at the sweeps a pencil of its size needs and
``mwf_bytes``, at the float32 peak) over the device time of the kernels those
calls launched."""


def read(ctx):
    bound = busy = 0.0
    for call in ctx.trace.ops:
        if call["name"] != "disco_torch::fused_mwf" or not call["kernels"]:
            continue
        dims = call["args"].get("Input Dims") or [[]]
        shape = dims[0]
        if len(shape) < 2:
            continue
        C = shape[-1]
        n = 1
        for d in shape[:-2]:
            n *= d
        mu_per_pencil = len(dims) > 2 and bool(dims[2]) and dims[2] != [1]
        c = ctx.costs
        bound += c.bound_s(c.mwf_flops(n, C), c.mwf_bytes(n, C, mu_per_pencil))[0]
        busy += sum(k.dur for k in call["kernels"]) / 1e6
    return 100.0 * bound / busy if busy > 0 else None

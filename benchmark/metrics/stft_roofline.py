"""``stft_roofline``: the STFT kernel's share of its roofline (``csrc/stft.cu``
through ``ops/stft_ops.py``).  Over the traced batches, the least time of
every ``disco_torch::stft`` call (``costs.stft_flops`` and ``stft_bytes`` of
its rows, length and magnitude flag, at the float32 peak) over the device
time of the kernels those calls launched."""


def read(ctx):
    bound = busy = 0.0
    for call in ctx.trace.ops:
        if call["name"] != "disco_torch::stft" or not call["kernels"]:
            continue
        dims = call["args"].get("Input Dims") or [[]]
        shape = dims[0]
        if len(shape) < 1:
            continue
        rows = 1
        for d in shape[:-1]:
            rows *= d
        length = shape[-1]
        concrete = call["args"].get("Concrete Inputs") or []
        with_mag = len(concrete) > 3 and concrete[3] == "True"
        c = ctx.costs
        bound += c.bound_s(c.stft_flops(rows, length, with_mag=with_mag),
                           c.stft_bytes(rows, length, with_mag=with_mag))[0]
        busy += sum(k.dur for k in call["kernels"]) / 1e6
    return 100.0 * bound / busy if busy > 0 else None

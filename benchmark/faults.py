"""What can run in the program's place, for the readings that set a cell's
limits (``benchmark/tools/readings.py``) and for the tests that see the check
fail: the control and the planted faults.  Each is a function of the
pipeline that returns the batch call to run in the window.  The benchmark's
own runs use none of them.

* ``control``: the reference put in the program's place, computed in the
  precision below the one the configurations state (float32 with TF32 off):
  float32 with TF32 allowed in every product and convolution.
* ``unfiltered``: the filter step returns its input unchanged: each node's
  reference-mic mixture comes out as the enhanced signal.
* ``half_batch``: half of the batch left out: the second half of the clips
  comes out as copies of the first half's results.
* ``no_exchange``: the exchange between nodes left out: step 2 receives
  zeros for the other nodes' compressed signals.
* ``altered``: an answer altered where it is produced: the first clip's
  first node comes out 1 % louder.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def tf32_allowed():
    """TF32 in cuBLAS products and cuDNN convolutions for the body, then
    the settings as they were."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = m, c


def control(pipe):
    def run(x):
        with tf32_allowed():
            return pipe.reference(x, torch.float32)
    return run


def program_tf32(pipe):
    """Not a fault of the list: the program itself with TF32 allowed, the
    step a later change might take; read beside the control."""
    def run(x):
        with tf32_allowed():
            return pipe.run(x)
    return run


def unfiltered(pipe):
    ref = pipe.cfg["ref_mic"]
    return lambda x: x[0][:, :, ref].clone()


def half_batch(pipe):
    def run(x):
        out = pipe.run(x)
        half = out.shape[0] // 2
        return torch.cat([out[:half], out[:out.shape[0] - half]])
    return run


def no_exchange(pipe):
    from disco_tpu_torch.enhance import tango as tango_mod

    step2 = tango_mod.tango_step2

    def cut(Y, S, N, mask_w_k, k, all_z, *args, **kwargs):
        zeroed = {key: torch.zeros_like(v) for key, v in all_z.items()}
        return step2(Y, S, N, mask_w_k, k, zeroed, *args, **kwargs)

    def run(x):
        tango_mod.tango_step2 = cut
        try:
            return pipe.run(x)
        finally:
            tango_mod.tango_step2 = step2
    return run


def altered(pipe):
    def run(x):
        out = pipe.run(x).clone()
        out[0, 0] *= 1.01
        return out
    return run


FAULTS = {"unfiltered": unfiltered, "half_batch": half_batch, "no_exchange": no_exchange,
          "altered": altered}

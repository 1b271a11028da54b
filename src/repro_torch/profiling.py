"""torch.profiler sessions on the card that hold every device record.

On the H100 (torch 2.11.0+cu128, its CUPTI) every profiling session of a
process but its first loses the records of the first kernels it runs: one
more for about every 12 s since the process's first session (20 at 240
s), whichever kernels they are, PyTorch's own as well as the port's, and
however the port's libraries link the CUDA runtime
(``tools/profiler_probe.py``).  A session opened by ``device_profile``
starts on the device with ``lead_in`` empty spin kernels, which take
those losses, and checks afterwards that one of them at least was
recorded: every record after it was.
"""
from __future__ import annotations

import contextlib

import torch

# spin kernels that open a session: a loss of 512 records would take some
# 100 minutes since the process's first session
LEAD_IN = 512
# the device kernel of torch.cuda._sleep, as the profiler names it
LEAD_IN_KERNEL = "spin_kernel"


@contextlib.contextmanager
def device_profile(lead_in: int = LEAD_IN):
    """``torch.profiler.profile`` of the host and the device over the
    block, opened on the device by ``lead_in`` empty spin kernels and
    closed by a synchronise.  Raises if no spin kernel's record survived
    (the loss may have reached the block).  Leave the kernels named
    ``LEAD_IN_KERNEL`` out of what the profile is read for."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(lead_in):
            torch.cuda._sleep(0)
        yield prof
        torch.cuda.synchronize()
    if lead_in and not any(LEAD_IN_KERNEL in e.key for e in prof.key_averages()):
        raise RuntimeError(f"the profiler dropped all {lead_in} lead-in kernels of the session; "
                           "it may have dropped the profiled work's too")

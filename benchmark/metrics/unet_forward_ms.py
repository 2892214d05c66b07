"""unet_forward_ms: device milliseconds of one UNet forward in the
profiled shape: the device events launched while a forward of the DDNM
network ran (of any client; its hooks log them, networks/ddnm.py), over
the forwards."""
from pdbench import trace


def read(run):
    if run.trace is None:
        return None
    s = trace.forward_device_s(run.trace, run.trace.forwards.get("ddnm"))
    return None if s is None else s * 1e3

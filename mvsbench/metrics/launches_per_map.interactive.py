"""Every kernel the card ran a map in the traced window (each kernel event
of the trace is one launch: ATen's, cuDNN's and the port's own)."""


def read(t, cfg):
    return None if not t.launches or not t.units else t.launches / t.units

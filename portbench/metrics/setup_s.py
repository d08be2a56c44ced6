"""setup_s (s, host clock): from the start of the process to the start of
the window: imports, weights drawn on the device, the program built, its
kernels and native libraries built or loaded, the traffic made and every
shape of the cell warmed."""


def read(rec):
    return rec.get("setup_s")

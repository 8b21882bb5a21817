"""Animation cells: frames whose uint8 RGB image reached the host, over
the window's seconds."""


def read(m):
    w = m.window
    return w["frames"] / w["seconds"] if w["seconds"] > 0 else None

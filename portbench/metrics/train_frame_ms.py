"""Train cells: the window's milliseconds over the frames it trained
(steps times B); every step of the window counts."""


def read(m):
    w = m.window
    return 1e3 * w["seconds"] / w["frames"] if w["frames"] else None

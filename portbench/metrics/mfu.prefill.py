"""Model FLOPs of the window's forwards (``work.model_flops``: matmul
FLOPs as the inputs need them) over the window's time and the card's
bfloat16 peak, in percent."""

from portbench.work import PEAKS


def read(r):
    if r.window_s <= 0 or not r.forwards:
        return None
    return 100.0 * r.forwards * r.model_flops / (r.window_s * PEAKS["bfloat16"])

"""The counted operations of the window's outer steps over its length times
the card's bf16 peak (dense, on the tensor cores): the DIP fit's
convolutions and B1, whose products the ``dip_fast`` configuration takes on
bf16 operands.  None off a card the peak table holds."""


def read(run):
    if run.peaks is None or run.window_s <= 0 or not run.flops:
        return None
    return 100.0 * run.flops / (run.window_s * run.peaks["bf16_flops"])

"""mfu.eval: the eval step's share of the card's bf16 dense peak (under
every policy, so that a change of precision shows): the configuration's
frozen forward FLOPs an image at the window's eval_img_s."""

from lhbench import readers


def read(run):
    return readers.mfu(run, "eval_img_s", run.cell.config["forward_flops"])

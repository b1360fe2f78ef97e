"""mfu.train: the training step's share of the card's bf16 dense peak: 3 x
the configuration's frozen forward FLOPs an image (no recompute) at the
window's train_img_s."""

from lhbench import readers, yardstick


def read(run):
    flops = yardstick.train_flops(run.cell.config["forward_flops"])
    return readers.mfu(run, "train_img_s", flops)

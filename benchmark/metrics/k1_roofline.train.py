"""k1_roofline.train: % of K1's least time on the card (bytes over the
memory rate or f32 operations over the f32 rate, whichever is larger;
frozen counts at the cell's batch) that its mean device time a launch is."""

from lhbench import readers, yardstick


def read(run):
    cfg, mix = run.cell.config, run.cell.mix
    work = yardstick.k1_work(mix["batch"], cfg["image_size"],
                             cfg["num_joints"], cfg["heatmap_size"])
    return readers.roofline(run, readers.K1_KERNEL, work)

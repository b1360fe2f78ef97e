"""attention_roofline.train: % of attention's least time on the card that
the "attention" family's device time a microbatch is. The least time is
each block's fused forward and backward at the cell's batch, heads and
tokens, each bound on its own by bytes or by bf16 tensor-core FLOPs
(``yardstick.attention_work``, ``yardstick.tensor_bound_s``)."""

import torch

from lhbench import yardstick


def read(run):
    s = run.summary
    if s is None or not s.units or not s.families.get("attention"):
        return None
    cfg, batch = run.cell.config, run.cell.mix["batch"]
    side = ((cfg["image_size"] + 2 * cfg["patch_padding"]
             - cfg["patch_size"]) // cfg["patch_size"] + 1)
    heads = cfg["num_heads"]
    kind = (torch.cuda.get_device_name(run.device)
            if run.device.type == "cuda" else "")
    least = cfg["depth"] * sum(
        yardstick.tensor_bound_s(*yardstick.attention_work(
            batch, heads, side * side, cfg["embed_dim"] // heads, backward),
            kind)
        for backward in (False, True))
    return 100.0 * least / (s.families["attention"] / s.units)

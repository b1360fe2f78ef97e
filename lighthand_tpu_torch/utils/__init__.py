from lighthand_tpu_torch.utils.weights import hrnet_from_flax, resnet_from_flax

__all__ = ["hrnet_from_flax", "resnet_from_flax"]

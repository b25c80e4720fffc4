"""Masking primitives with the TF reference's multiplicative form
`x * m + (-1e30) * (1 - m)`, computed in fp32. Never -inf: a fully masked
row then gives a uniform softmax instead of NaN, as in the JAX package."""
import torch

MASK_VALUE = -1e30


def mask_logits(inputs, mask, mask_value=MASK_VALUE):
    mask = mask.to(torch.float32)
    return inputs.to(torch.float32) * mask + mask_value * (1.0 - mask)


def sequence_mask(lengths, maxlen, dtype=torch.int32):
    """[B] lengths -> [B, maxlen] 0/1 mask (tf.sequence_mask)."""
    pos = torch.arange(maxlen, device=lengths.device, dtype=lengths.dtype)
    return (pos[None, :] < lengths[:, None]).to(dtype)

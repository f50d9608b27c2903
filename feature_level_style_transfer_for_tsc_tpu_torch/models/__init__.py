"""OS-CNN model family, the flow, adapters, critics, CPC, the transformer
discriminator and shared primitives."""

from .transformer import (  # noqa: F401
    discriminator_att_apply,
    discriminator_att_init,
    seq_transformer_apply,
    seq_transformer_init,
)

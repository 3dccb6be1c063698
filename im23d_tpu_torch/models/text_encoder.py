"""Caption encoder for the text-conditional GAN (counterpart of
``im23d_tpu/models/text_encoder.py``): a bidirectional LSTM over caption
tokens that gives per-word features for ``SpatialAttention``
(``models/gan.py``) and a sentence embedding.

The layers carry AttnGAN's ``RNN_Encoder`` names, ``encoder`` (the word
embedding) and ``rnn`` (``nn.LSTM``, one layer, both directions), so an
AttnGAN state dict loads with ``load_state_dict``; ``core/convert.py``
maps the JAX package's flax cells onto them.

The sequences are not packed: flax's ``nn.RNN`` gets no ``seq_lengths``,
so its backward direction starts from the zero padding at the tail, and an
unpacked bidirectional ``nn.LSTM`` runs the same way.  The word features
are masked by ``tokens != 0`` after the LSTM; the sentence embedding is
their mean over the unpadded words (a denominator of at least 1).
"""

from __future__ import annotations

import math

import torch
from torch import nn


class TextEncoder(nn.Module):
    """tokens (B, L) int (0 = pad) -> (words (B, L, 2H), sent (B, 2H)),
    float32."""

    def __init__(self, vocab_size: int, embedding_dim: int = 256,
                 hidden_dim: int = 128):
        super().__init__()
        self.vocab_size = vocab_size
        self.embedding_dim = embedding_dim
        self.hidden_dim = hidden_dim
        self.encoder = nn.Embedding(vocab_size, embedding_dim)
        self.rnn = nn.LSTM(embedding_dim, hidden_dim, batch_first=True,
                           bidirectional=True)

    def forward(self, tokens: torch.Tensor):
        tokens = tokens.long()
        words, _ = self.rnn(self.encoder(tokens))  # (B, L, 2H)
        mask = (tokens != 0).to(words.dtype)
        words = words * mask[..., None]
        denom = mask.sum(dim=1, keepdim=True).clamp_min(1.0)
        return words, words.sum(dim=1) / denom


def caption_mask(tokens: torch.Tensor) -> torch.Tensor:
    """The padding mask ``SpatialAttention`` takes: True where padded."""
    return tokens == 0


def text_encoder_init_(enc: TextEncoder, generator: torch.Generator) -> None:
    """flax's default init, drawn from ``generator``: the embedding normal
    with variance 1 / rows; per gate, LeCun truncated-normal input weights
    and orthogonal recurrent weights; zero biases (``OptimizedLSTMCell``
    carries one bias per gate, here ``bias_ih``)."""
    H = enc.hidden_dim
    std = math.sqrt(1.0 / enc.embedding_dim) / 0.87962566103423978
    with torch.no_grad():
        enc.encoder.weight.normal_(0.0, 1.0 / math.sqrt(enc.vocab_size),
                                   generator=generator)
        for suffix in ("", "_reverse"):
            w_ih = getattr(enc.rnn, f"weight_ih_l0{suffix}")
            w_hh = getattr(enc.rnn, f"weight_hh_l0{suffix}")
            for g in range(4):
                nn.init.trunc_normal_(w_ih[g * H:(g + 1) * H], 0.0, std,
                                      -2 * std, 2 * std, generator=generator)
                nn.init.orthogonal_(w_hh[g * H:(g + 1) * H],
                                    generator=generator)
            getattr(enc.rnn, f"bias_ih_l0{suffix}").zero_()
            getattr(enc.rnn, f"bias_hh_l0{suffix}").zero_()

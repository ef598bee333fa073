"""The motion discriminator: a GRU over pose-parameter sequences (port
of ``scat_tpu/models/discriminator.py:21-92``; reference
models/motion_discriminator.py:28-139).

[batch, seqlen, input_size] -> stacked GRU -> pooled over time
("concat": the mean and the max of the ReLU'd states; "attention": the
``SelfAttention`` MLP's softmax weights; anything else: the last state)
-> ``fc`` to ``output_size``, optionally spectrally normalised.

The GRU is torch's ``nn.GRU`` (cuDNN on the card), batch-first, the
gates of flax's ``GRUCell`` (``utils/weights`` maps them).  Dropout in
the attention pooling applies only where ``forward`` is given its
keep-masks: the JAX package's step applies the discriminator
deterministically on both sides, and so does the port's, with the
module left in training mode because cuDNN's GRU backward needs it.

Spectral norm is flax's ``nn.SpectralNorm`` (n_steps 1, eps 1e-12): each
forward runs one power iteration from the stored ``fc_u`` [1, out] and
divides ``fc``'s weight by the resulting sigma (gradients through the
weight, not through u and v); ``fc_u`` and ``fc_sigma`` are updated only
under ``update_sn_stats=True``, which the adversarial step never passes.
``torch.nn.utils.parametrizations.spectral_norm`` updates u on every
training forward, so it is not used.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from scat_tpu_torch.models.transformer import dropout
from scat_tpu_torch.utils.checkpoint import lecun_normal_


class SelfAttention(nn.Module):
    """MLP attention pooling (reference motion_discriminator.py:28-81):
    ``layers - 1`` hidden Linear layers of ``attention_size``, then a
    Linear to one score a step; activation tanh (or relu) after each;
    softmax over time; returns (the weighted sum [B,F], scores [B,T]).
    Keys ``attention.{3 i}`` (Linear, activation, dropout a layer)."""

    def __init__(self, input_size: int, attention_size: int,
                 layers: int = 1, dropout: float = 0.0,
                 non_linearity: str = "tanh"):
        super().__init__()
        self.dropout = dropout
        act = nn.ReLU() if non_linearity == "relu" else nn.Tanh()
        modules = []
        width = input_size
        for _ in range(layers - 1):
            modules += [nn.Linear(width, attention_size), act, nn.Identity()]
            width = attention_size
        modules += [nn.Linear(width, 1), act, nn.Identity()]
        self.attention = nn.Sequential(*modules)

    def forward(self, inputs: torch.Tensor,
                keep: Optional[Sequence[torch.Tensor]] = None):
        """``keep``: one keep-mask per layer (the hidden layers' [B,T,A],
        the scores' [B,T,1]), or None for no dropout."""
        x = inputs
        linears = [m for m in self.attention if isinstance(m, nn.Linear)]
        for i, linear in enumerate(linears):
            x = dropout(self.attention[3 * i + 1](linear(x)),
                        None if keep is None else keep[i], self.dropout)
        scores = torch.softmax(x.squeeze(-1), dim=-1)
        return (inputs * scores[..., None]).sum(dim=1), scores


def _l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum() + eps)


class MotionDiscriminator(nn.Module):
    """reference motion_discriminator.py:83-139; [B,T,input_size] ->
    [B,output_size]."""

    def __init__(self, rnn_size: int, input_size: int, num_layers: int,
                 output_size: int = 2, feature_pool: str = "concat",
                 use_spectral_norm: bool = False,
                 attention_size: int = 1024, attention_layers: int = 1,
                 attention_dropout: float = 0.5):
        super().__init__()
        self.feature_pool = feature_pool
        self.use_spectral_norm = use_spectral_norm
        self.gru = nn.GRU(input_size, rnn_size, num_layers,
                          batch_first=True)
        linear_size = rnn_size * 2 if feature_pool == "concat" else rnn_size
        if feature_pool == "attention":
            self.attention = SelfAttention(rnn_size, attention_size,
                                           attention_layers,
                                           attention_dropout)
        self.fc = nn.Linear(linear_size, output_size)
        if use_spectral_norm:
            self.register_buffer("fc_u", torch.randn(1, output_size))
            self.register_buffer("fc_sigma", torch.ones(()))

    def init_weights(self, generator: torch.Generator) -> None:
        """flax's init of the JAX package's module: the GRU's input
        kernels and every Linear truncated lecun-normal, its recurrent
        kernels orthogonal (a gate at a time), biases zero; the spectral
        norm's u normal(1), sigma one."""
        with torch.no_grad():
            for name, p in self.gru.named_parameters():
                if name.startswith("bias"):
                    p.zero_()
                    continue
                for gate in p.chunk(3):
                    if name.startswith("weight_ih"):
                        lecun_normal_(gate, generator)
                    else:
                        nn.init.orthogonal_(gate, generator=generator)
            for m in self.modules():
                if isinstance(m, nn.Linear):
                    lecun_normal_(m.weight, generator)
                    m.bias.zero_()
            if self.use_spectral_norm:
                self.fc_u.normal_(generator=generator)
                self.fc_sigma.fill_(1.0)

    def _fc(self, h: torch.Tensor, update_sn_stats: bool) -> torch.Tensor:
        if not self.use_spectral_norm:
            return self.fc(h)
        w = self.fc.weight  # [out, in]: flax's kernel transposed
        with torch.no_grad():
            v = _l2_normalize(self.fc_u @ w)
            u = _l2_normalize(v @ w.T)
        sigma = (v @ w.T @ u.T)[0, 0]
        if update_sn_stats:
            with torch.no_grad():
                self.fc_u.copy_(u)
                self.fc_sigma.copy_(sigma)
        w = w / torch.where(sigma != 0, sigma, torch.ones_like(sigma))
        return torch.nn.functional.linear(h, w, self.fc.bias)

    def forward(self, sequence: torch.Tensor,
                attention_keep: Optional[Sequence[torch.Tensor]] = None,
                update_sn_stats: bool = False) -> torch.Tensor:
        """``attention_keep``: the attention pooling's dropout keep-masks
        (none: deterministic, as the adversarial step applies it)."""
        x, _ = self.gru(sequence.float())  # [B, T, rnn_size]
        if self.feature_pool == "concat":
            h = torch.relu(x)
            y = torch.cat([h.mean(dim=1), h.amax(dim=1)], dim=1)
        elif self.feature_pool == "attention":
            y, _ = self.attention(x, attention_keep)
        else:
            y = x[:, -1]
        return self._fc(y, update_sn_stats)

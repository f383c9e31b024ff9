"""Encoder-decoder transformer with teacher forcing (port of
models/enc_dec.py, the 'enc-dec' model family).

The decoder's input is the target sin/cos angles shifted right one step,
with a start row of -0.1 and missing (NaN) entries set to 0. Three ways to
decode:

* ``forward_tf``: complete teacher forcing, one decoder pass under a causal
  mask;
* ``forward``: teacher forcing when either fraction is >= 1, and in eval
  mode (the JAX package passes its eval steps, its predict and its
  structure logging no sampling key, so there it raises when a fraction is
  below 1; the port evaluates and predicts such a run teacher-forced);
  otherwise, in train mode, full teacher forcing with probability
  ``fraction_complete_tf`` and else scheduled sampling, where the input of
  each timestep t >= 1 is replaced by the model's own prediction for it with
  probability 1 - ``fraction_subseq_tf``. Every replacement decodes the
  full padded length under the causal mask (positions < t come out as a
  growing prefix would give them), and a last full decode gives all L
  positions. The JAX package runs a decode for every timestep inside
  ``lax.scan`` and drops those it does not feed back; here a timestep that
  keeps its target runs none, which gives the same output. Gradients flow
  through the fed predictions;
* ``predict``: fully autoregressive decoding in eval mode.

The draws of ``forward`` come from ``sampling_generator``, a CPU
``torch.Generator`` that the trainer owns and seeds apart from the dropout
generator, never from torch's global one; they decide which passes run, so
they are drawn on the host.

The output projection starts with a tiny-gain Xavier weight and the raw
angle means as bias, though a tanh follows (the reference's choice). The
decoder's attention is causal or cross, so ``attn_impl`` reaches the
encoder's key-padding self-attention only. Encoder and decoder compute in
``dtype`` (models/transformer.py); the projection, its tanh and the fed-back
predictions stay in float32, as in the JAX package.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from protein_transformer_tpu_torch.models.encoder_only import (
    key_padding_mask)
from protein_transformer_tpu_torch.models.transformer import Decoder, Encoder
from protein_transformer_tpu_torch.protein.constants import (
    NUM_PREDICTED_ANGLES)

SOS_VALUE = -0.1
MISSING_COORD_FILLER = 0.0
# gain of the output projection's Xavier-uniform weight: flax's
# variance_scaling(1e-10, "fan_avg", "uniform")
OUTPUT_GAIN = math.sqrt(1e-10)


class Transformer(nn.Module):
    """'enc-dec' model family: ``model(ids, tgt_angles)`` -> (B, L, 24)."""

    def __init__(self, n_enc_layers: int, n_dec_layers: int, n_heads: int,
                 d_model: int, d_ff: int, max_len: int, vocab_size: int,
                 angle_means, dropout: float = 0.1, pad_id: int = 20,
                 prenorm: bool = True, fraction_complete_tf: float = 1.0,
                 fraction_subseq_tf: float = 1.0, attn_impl: str = "xla",
                 dtype=None):
        super().__init__()
        d_out = NUM_PREDICTED_ANGLES * 2
        self.pad_id = pad_id
        self.fraction_complete_tf = fraction_complete_tf
        self.fraction_subseq_tf = fraction_subseq_tf
        self.sampling_generator: torch.Generator | None = None
        self.encoder = Encoder(vocab_size, d_model, d_ff, n_heads,
                               n_enc_layers, max_len, dropout, prenorm,
                               attn_impl, dtype)
        self.decoder = Decoder(d_out, d_model, d_ff, n_heads, n_dec_layers,
                               max_len, dropout, prenorm, dtype)
        self.output_projection = nn.Linear(d_model, d_out)
        with torch.no_grad():
            nn.init.xavier_uniform_(self.output_projection.weight,
                                    gain=OUTPUT_GAIN)
            self.output_projection.bias.copy_(torch.from_numpy(
                np.asarray(angle_means, np.float32)))

    def _masks(self, ids):
        length = ids.shape[1]
        causal = torch.ones((length, length), dtype=torch.bool,
                            device=ids.device).tril()[None, None]
        return key_padding_mask(ids, self.pad_id), causal

    @staticmethod
    def _shift_right(tgt):
        tgt = torch.nan_to_num(tgt, nan=MISSING_COORD_FILLER)
        shifted = torch.roll(tgt, 1, dims=1)
        shifted[:, 0, :] = SOS_VALUE
        return shifted

    def _decode(self, dec_input, enc_out, causal, src_mask):
        out = self.decoder(dec_input, enc_out, causal, src_mask)
        return torch.tanh(self.output_projection(
            out.to(self.output_projection.weight.dtype)))

    def forward_tf(self, ids, tgt_angles):
        src_mask, causal = self._masks(ids)
        enc_out = self.encoder(ids, src_mask)
        return self._decode(self._shift_right(tgt_angles), enc_out, causal,
                            src_mask)

    def forward(self, ids, tgt_angles):
        if (not self.training or self.fraction_complete_tf >= 1.0
                or self.fraction_subseq_tf >= 1.0):
            return self.forward_tf(ids, tgt_angles)
        if self._uniform(1)[0] < self.fraction_complete_tf:
            return self.forward_tf(ids, tgt_angles)
        return self._scheduled_sampling(ids, tgt_angles)

    def _uniform(self, n: int) -> list[float]:
        """n draws from U[0, 1) out of the sampling generator."""
        if self.sampling_generator is None:
            raise RuntimeError(
                "scheduled sampling needs a generator: set "
                "model.sampling_generator to a CPU torch.Generator")
        return torch.rand(n, generator=self.sampling_generator).tolist()

    def _scheduled_sampling(self, ids, tgt_angles):
        src_mask, causal = self._masks(ids)
        enc_out = self.encoder(ids, src_mask)
        work = self._shift_right(tgt_angles)
        length = ids.shape[1]
        draws = self._uniform(length)
        for t in range(1, length):
            if draws[t] > self.fraction_subseq_tf:
                out = self._decode(work, enc_out, causal, src_mask)
                # a new tensor: the old one is saved for the backward
                work = torch.cat([work[:, :t], out[:, t - 1:t],
                                  work[:, t + 1:]], dim=1)
        return self._decode(work, enc_out, causal, src_mask)

    @torch.no_grad()
    def predict(self, ids):
        """Autoregressive decoding, dropout off whatever the mode."""
        was_training = self.training
        self.eval()
        try:
            src_mask, causal = self._masks(ids)
            enc_out = self.encoder(ids, src_mask)
            bsz, length = ids.shape
            work = torch.full((bsz, length, NUM_PREDICTED_ANGLES * 2),
                              SOS_VALUE,
                              dtype=self.output_projection.weight.dtype,
                              device=ids.device)
            for t in range(1, length):
                out = self._decode(work, enc_out, causal, src_mask)
                work[:, t] = out[:, t - 1]
            return self._decode(work, enc_out, causal, src_mask)
        finally:
            self.train(was_training)

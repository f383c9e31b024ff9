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
  through the fed predictions. Each fed-back pass is recomputed in the
  backward rather than kept (``torch.utils.checkpoint``), so the sampled
  path holds one pass's activations and a (B, L, 24) input per pass, where
  keeping them all would take ~1.35 GB a pass at d_model 512 x 6 layers,
  B=8 x L=256, and ~255 passes at most. The recomputation replays the
  pass's dropout masks from the dropout generator's state saved before the
  pass, then puts the generator back where it stood, so outputs, gradients
  and the generator's state are those of a loop that keeps every pass;
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
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from protein_transformer_tpu_torch.models.encoder_only import (
    key_padding_mask)
from protein_transformer_tpu_torch.models.transformer import (
    Decoder, Dropout, Encoder)
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

    def _decode(self, dec_input, enc_out, causal, src_mask, weights=None):
        """The decoder and the output head, on ``weights`` where given: the
        two modules' parameters by name, as ``functional_call`` takes them."""
        dec_w, head_w = weights if weights is not None else (None, None)
        out = self._call(self.decoder, dec_w, dec_input, enc_out, causal,
                         src_mask)
        head = self.output_projection
        dtype = (head.weight if head_w is None else head_w["weight"]).dtype
        return torch.tanh(self._call(head, head_w, out.to(dtype)))

    @staticmethod
    def _call(module, params, *args):
        """``module(*args)``, on ``params`` where given."""
        if params is None:
            return module(*args)
        return functional_call(module, params, args)

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
        # the weights the passes compute with: under functional_call the
        # caller's, which the recomputation in the backward, after that call
        # has returned, must take again
        weights = (dict(self.decoder.named_parameters()),
                   dict(self.output_projection.named_parameters()))
        generators = self._dropout_generators()
        for t in range(1, length):
            if draws[t] > self.fraction_subseq_tf:
                work = checkpoint(self._sampled_pass(weights, generators),
                                  work, enc_out, causal, src_mask, t,
                                  use_reentrant=False,
                                  preserve_rng_state=False)
        return self._decode(work, enc_out, causal, src_mask)

    def _dropout_generators(self) -> list:
        """The generators the decoder's dropout masks come from in this
        mode, each once."""
        generators = []
        for m in self.decoder.modules():
            if (isinstance(m, Dropout) and m.training and m.p > 0
                    and m.generator is not None
                    and all(g is not m.generator for g in generators)):
                generators.append(m.generator)
        return generators

    def _sampled_pass(self, weights: tuple, generators: list):
        """One fed-back pass on ``weights`` (the decoder's and the head's,
        as ``_decode`` takes them), ``(work, enc_out, causal, src_mask, t)
        -> work`` with the prediction for t in row t. A second call is the
        backward's recomputation: it draws the first call's dropout masks
        again from the generators' states taken here, and leaves the
        generators as it found them, also when the recomputation stops
        early."""
        states = [g.get_state() for g in generators]
        first = True

        def run(work, enc_out, causal, src_mask, t):
            nonlocal first
            restore = []
            if not first:
                restore = [g.get_state() for g in generators]
                for g, s in zip(generators, states):
                    g.set_state(s)
            first = False
            try:
                out = self._decode(work, enc_out, causal, src_mask, weights)
            finally:
                for g, s in zip(generators, restore):
                    g.set_state(s)
            return torch.cat([work[:, :t], out[:, t - 1:t], work[:, t + 1:]],
                             dim=1)

        return run

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

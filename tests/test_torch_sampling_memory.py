"""The encoder-decoder's scheduled-sampling path recomputes each fed-back
decoder pass in the backward (models/enc_dec.py::_scheduled_sampling).

Against a loop that keeps every pass (the path before the recomputation,
kept here as the reference), through ``torch.func.functional_call`` as the
trainer calls the model, so that the recomputation, which runs after that
call has returned, must take the caller's weights again:

* at dropout 0 the same output and every parameter gradient, within 1e-6
  relative;
* at dropout 0.1, from one seeded dropout generator, the same output and
  gradients (the recomputed passes draw their masks again) and the same
  generator state after forward and backward;
* the bytes that ``torch.autograd.graph.saved_tensors_hooks`` sees saved
  for the backward stay under two passes' activations plus the per-pass
  (B, L, 24) inputs, where the kept loop's grow with the passes;
* on a card, a sampled step makes no stream synchronisation.

No JAX here: the JAX parity of the sampled path is
tests/test_torch_enc_dec.py::test_fully_sampled_path_matches_jax. The card
test runs with
``python -m pytest --noconftest -m needs_cuda tests/test_torch_sampling_memory.py``.
"""
import numpy as np
import pytest
import torch

from protein_transformer_tpu_torch.models import enc_dec as ted
from protein_transformer_tpu_torch.models.transformer import (
    set_dropout_generator)
from protein_transformer_tpu_torch.protein.vocab import VOCAB

B, L, DM, DFF, NH, NL = 2, 24, 32, 64, 2, 2
RTOL = 1e-6
WORK_BYTES = B * L * 24 * 4  # one pass's (B, L, 24) float32 input


@pytest.fixture(autouse=True)
def one_thread():
    """The steps here are narrow: one intra-op thread runs them as fast as
    eight, and does not crawl when six test workers share the machine's
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class KeptTransformer(ted.Transformer):
    """The sampled path that keeps every decoder pass for the backward."""

    def _scheduled_sampling(self, ids, tgt_angles):
        src_mask, causal = self._masks(ids)
        enc_out = self.encoder(ids, src_mask)
        work = self._shift_right(tgt_angles)
        length = ids.shape[1]
        draws = self._uniform(length)
        for t in range(1, length):
            if draws[t] > self.fraction_subseq_tf:
                out = self._decode(work, enc_out, causal, src_mask)
                work = torch.cat([work[:, :t], out[:, t - 1:t],
                                  work[:, t + 1:]], dim=1)
        return self._decode(work, enc_out, causal, src_mask)


def make(cls, dropout, fraction_subseq_tf=0.5, device="cpu"):
    return cls(n_enc_layers=NL, n_dec_layers=NL, n_heads=NH, d_model=DM,
               d_ff=DFF, max_len=L, vocab_size=len(VOCAB),
               angle_means=np.zeros(24, np.float32), dropout=dropout,
               pad_id=VOCAB.pad_id, fraction_complete_tf=0.0,
               fraction_subseq_tf=fraction_subseq_tf).to(device).train()


def weights(model, device="cpu"):
    """Parameters apart from the module's own, with a head that reaches the
    trunk (standard deviation 0.05 keeps the tanh unsaturated)."""
    gen = torch.Generator().manual_seed(6)
    return {k: (v.detach().cpu() + 0.05 * torch.randn(v.shape, generator=gen)
                ).to(device).requires_grad_()
            for k, v in model.named_parameters()}


def inputs(device="cpu"):
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 20, (B, L))
    ids[0, -3:] = VOCAB.pad_id
    tgt = rng.uniform(-0.9, 0.9, (B, L, 24)).astype(np.float32)
    tgt[1, 4] = np.nan
    return (torch.from_numpy(ids).long().to(device),
            torch.from_numpy(tgt).to(device))


def step(model, params, device="cpu"):
    """Output, gradients of every parameter and the dropout generator's
    state after one sampled forward and backward."""
    model.sampling_generator = torch.Generator().manual_seed(5)
    gen = torch.Generator(device=device).manual_seed(7)
    set_dropout_generator(model, gen)
    out = torch.func.functional_call(model, params, inputs(device))
    grads = torch.autograd.grad((out * torch.linspace(
        -1, 1, out.numel(), device=device).view_as(out)).sum(),
        list(params.values()))
    return out.detach(), grads, gen.get_state()


def passes_of(model) -> int:
    model.sampling_generator = torch.Generator().manual_seed(5)
    model._uniform(1)  # forward's draw for complete teacher forcing
    draws = model._uniform(L)
    return sum(d > model.fraction_subseq_tf for d in draws[1:])


def assert_same(got, want):
    (o1, g1, s1), (o2, g2, s2) = got, want
    torch.testing.assert_close(o1, o2, rtol=RTOL, atol=0)
    for a, b in zip(g1, g2):
        assert float((a - b).abs().max()) <= RTOL * float(b.abs().max())
    return s1, s2


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_recomputed_passes_give_the_kept_loops_output_and_gradients(dropout):
    kept = make(KeptTransformer, dropout)
    model = make(ted.Transformer, dropout)
    model.load_state_dict(kept.state_dict())
    params = weights(kept)
    assert passes_of(model) >= 8
    got, want = step(model, params), step(kept, params)
    state, kept_state = assert_same(got, want)
    # every gradient reaches the caller's weights, decoder and head included
    assert all(float(g.abs().max()) > 0 for g in got[1])
    # the generator stands where the kept loop leaves it: the replays put
    # it back
    assert torch.equal(state, kept_state)
    if dropout:
        # the masks matter: another dropout stream gives other gradients
        model.sampling_generator = torch.Generator().manual_seed(5)
        set_dropout_generator(model, torch.Generator().manual_seed(8))
        other = torch.func.functional_call(model, params, inputs())
        assert float((other.detach() - got[0]).abs().max()) > 1e-4


def activation_bytes(model, params, fn) -> int:
    """Bytes of the distinct storages saved for the backward while fn()
    runs, the parameters (``params`` and the model's own) left out."""
    held = {p.untyped_storage().data_ptr()
            for p in [*params.values(), *model.parameters()]}
    storages = {}

    def pack(t):
        s = t.untyped_storage()
        storages[s.data_ptr()] = s.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return sum(n for ptr, n in storages.items() if ptr not in held)


def test_saved_activations_stay_one_pass_as_passes_grow():
    ids, tgt = inputs()
    by_fraction = {}
    for fraction in (0.8, 0.2):
        kept = make(KeptTransformer, 0.1, fraction)
        model = make(ted.Transformer, 0.1, fraction)
        model.load_state_dict(kept.state_dict())
        params = weights(kept)
        runs = {}
        for name, m in (("kept", kept), ("recomputed", model)):
            m.sampling_generator = torch.Generator().manual_seed(5)
            set_dropout_generator(m, torch.Generator().manual_seed(7))
            runs[name] = activation_bytes(m, params, lambda m=m: (
                torch.func.functional_call(m, params, (ids, tgt))))
        set_dropout_generator(model, torch.Generator().manual_seed(7))
        # one teacher-forced forward: the encoder and one decoder pass
        one = activation_bytes(model, params,
                               lambda: model.forward_tf(ids, tgt))
        encoder = activation_bytes(model, params, lambda: model.encoder(
            ids, model._masks(ids)[0]))
        by_fraction[fraction] = (passes_of(model), runs, one, one - encoder)
    for passes, runs, one, decoder_pass in by_fraction.values():
        assert passes >= 3 and decoder_pass > 10 * WORK_BYTES
        assert runs["recomputed"] <= 2 * one + passes * WORK_BYTES, (
            passes, runs, one)
        assert runs["kept"] >= one + passes * decoder_pass // 2, (
            passes, runs, one, decoder_pass)
    (few, few_runs, _, _), (many, many_runs, _, pass_bytes) = (
        by_fraction[0.8], by_fraction[0.2])
    assert many > 2 * few
    # the kept loop grows by about a pass a pass; the recomputed path by a
    # (B, L, 24) input a pass at most
    assert (many_runs["kept"] - few_runs["kept"]
            >= (many - few) * pass_bytes // 2)
    assert (0 <= many_runs["recomputed"] - few_runs["recomputed"]
            <= (many - few) * WORK_BYTES)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.needs_cuda
def test_sampled_step_never_synchronises_on_card(cuda):
    """A sampled forward and backward on the card, the recomputations'
    generator states taken and set included, without a stream
    synchronisation, and equal to the kept loop's."""
    kept = make(KeptTransformer, 0.1, device=cuda)
    model = make(ted.Transformer, 0.1, device=cuda)
    model.load_state_dict(kept.state_dict())
    params = weights(kept, cuda)
    want = step(kept, params, device=cuda)
    step(model, params, device=cuda)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = step(model, params, device=cuda)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    state, kept_state = assert_same(got, want)
    assert torch.equal(state, kept_state)

"""Device time of the flash attention's backward and of a flash training
step, on one GPU.

Times the port whose ``protein_transformer_tpu_torch`` this imports. Run as
a script with another checkout's root first on ``PYTHONPATH`` it times that
checkout's kernels instead, so that two versions can be compared in one
session on one card:

* at (B, H, L, D) = (8, 8, 256, 64), the eval and predict batches',
  (16, 8, 256, 64), the flash training step's, and (8, 8, 500, 64), the
  longest proteins, on the inputs of phase 8 of ``chip_smoke.py``
  (head-split views, q three times wider than k, ragged valid lengths, one
  batch row with no valid key), and at (16, 8, 256, 64) with the training
  batches' mask (15 full rows and one with no valid key): the device time
  of K3a without and with the row statistics m and l (as eval and predict,
  and as training call it), of the library's forward
  (``scaled_dot_product_attention`` with the same mask, a yardstick that
  the port never calls), of the backward that autograd runs through
  ``FlashSelfAttention`` (every kernel it puts on the device) and of
  autograd's backward through the library call; where the port has the one
  backward kernel, also that kernel asked for dQ alone and for dK, dV
  alone; each from a ``torch.profiler`` trace of five calls;
* the flagship conv-enc training step at dropout 0 with flash attention
  (d_model 512, 8 heads, 6 layers, batches of 15 proteins of length 255-256
  padded to B=16 x L=256, random seeded weights): device operations and
  device ms per step, from a trace of three steps.

    python -m protein_transformer_tpu_torch.tools.bench_attention \\
        [--level kernels|op|eval|all]
    PYTHONPATH=<other checkout> python <this file>

``--level op`` and ``--level eval`` run the JAX tool's two levels instead
(``--level all``: all three):

* op: masked self-attention forward, and forward + backward (the gradient
  of the valid rows' sum), at the JAX tool's shapes (B, H, L, d_model) =
  (8, 8, 256, 512), (4, 8, 500, 1024) and (64, 8, 500, 1024) on its inputs
  (numpy ``default_rng(0)``, valid lengths from L/2 to L): the materialised
  masked softmax (the plain version, ``flash_self_attention_torch``)
  against ``flash_self_attention`` (K3a and the flash backward); the
  largest difference of the outputs on valid rows and of the gradients,
  and the p50 ms of each by paired windows of calls chained through q;
* eval: ``Trainer.eval_step`` (the model and every dRMSD metric) of the
  conv-enc model at d_model 1024, d_ff 4096, 8 heads, 6 layers, lndrmsd
  with the backbone term, L = 500, at B = 4 and B = 32, with
  ``attention_impl`` xla and flash, from the same random seeded weights:
  the p50 ms of each by paired windows and the largest difference of the
  packed metrics.

``--dtype bfloat16`` times the bf16 instances instead: the same inputs
rounded to bf16, the library call on them, and the training step under
``compute_dtype="bfloat16"`` (a checkout without bf16 kernels raises).

Prints one line per measurement with the card's name and power limit, then
the results as one JSON object. Needs a CUDA device and raises without one.
"""
from __future__ import annotations

import argparse
import json
import math
import re
import statistics
import tempfile

import numpy as np
import torch

from protein_transformer_tpu_torch.config import TrainConfig
from protein_transformer_tpu_torch.data.dataset import collate
from protein_transformer_tpu_torch.data.synthetic import make_dataset
from protein_transformer_tpu_torch.device import cuda_device
from protein_transformer_tpu_torch.ops import attention as A
from protein_transformer_tpu_torch.tools.bench_drmsd_kernel import (
    card_label, device_ms, device_records)
from protein_transformer_tpu_torch.training.batch_probe import release_memory
from protein_transformer_tpu_torch.training.trainer import (
    Trainer, unpack_metrics)

# The op and eval levels import tools/bench_ladder.py's window helpers where
# they run: run by path against another checkout's package, the kernels
# level needs nothing that checkout may lack.

# (B, H, L, D), mask: "ragged" as phase 8 of chip_smoke.py draws it, or
# "train", the training batches' (15 full rows, one with no valid key)
CASES = (((8, 8, 256, 64), "ragged"), ((16, 8, 256, 64), "ragged"),
         ((8, 8, 500, 64), "ragged"), ((16, 8, 256, 64), "train"))
MODEL = "conv-enc|21,11,3|1,1,1"
# the op level's (B, H, L, d_model), the JAX tool's: head dims 64, 128, 128
OP_SHAPES = ((8, 8, 256, 512), (4, 8, 500, 1024), (64, 8, 500, 1024))
# the eval level's batches, and paired windows of k calls, six times
EVAL_BATCHES = (4, 32)
WINDOW_CALLS = 20
WINDOW_REPEATS = 6


def attention_inputs(device, shape, seed, mask="ragged",
                     dtype=torch.float32):
    """q, k, v (head-split views in ``dtype``; standard deviations 3, 1,
    1), dO and the mask: ragged valid lengths, or with ``mask="train"``
    every row full; the first batch row full and the last with no valid
    key."""
    bsz, heads, length, dim = shape
    rng = np.random.default_rng(seed)
    q, k, v, d_out = (
        torch.from_numpy(rng.normal(0, gain, (bsz, length, heads * dim))
                         .astype(np.float32)).to(device, dtype)
        .reshape(bsz, length, heads, dim).transpose(1, 2)
        for gain in (3.0, 1.0, 1.0, 1.0))
    n_valid = (rng.integers(1, length + 1, bsz) if mask == "ragged"
               else np.full(bsz, length))
    n_valid[0] = length
    n_valid[-1] = 0
    valid = torch.from_numpy(
        np.arange(length)[None, :] < n_valid[:, None]).to(device)
    return q, k, v, d_out, valid


def kernel_name(key: str) -> str:
    """A profiler key without its namespace, template and parameters."""
    return re.split(r"[<(]", key.split("::", 1)[-1])[0].strip()


def attention_times(device, shape, mask, seed=0,
                    dtype=torch.float32) -> dict:
    """Device ms of K3a (without and with m and l), of the library's
    forward, of the backward through ``FlashSelfAttention`` and of the
    library's backward at one (B, H, L, D) and mask, the device operations
    of one backward and, with the one backward kernel, the device ms of each
    of its roles alone."""
    q, k, v, d_out, valid = attention_inputs(device, shape, seed, mask,
                                             dtype)
    scale = 1.0 / math.sqrt(shape[-1])
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = A.flash_self_attention(*leaves, valid, sm_scale=scale, impl="cuda")
    lib_out = torch.nn.functional.scaled_dot_product_attention(
        *leaves, attn_mask=valid[:, None, None, :], scale=scale)

    def backward(o):
        return lambda: torch.autograd.grad(o, leaves, d_out,
                                           retain_graph=True)

    calls = 5
    records = device_records(backward(out), calls)

    def library_forward():
        with torch.no_grad():
            return torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=valid[:, None, None, :], scale=scale)

    times = {
        "forward_device_ms": device_ms(
            lambda: A.flash_attn_fwd_cuda(q, k, v, valid, scale)),
        "forward_stats_device_ms": device_ms(
            lambda: A.flash_attn_fwd_cuda(q, k, v, valid, scale,
                                          with_stats=True)),
        "library_forward_device_ms": device_ms(library_forward),
        "backward_device_ms": device_ms(backward(out)),
        "backward_device_ops": sum(e.count for e in records) / calls,
        "backward_kernels": sorted({kernel_name(e.key) for e in records}),
        "library_backward_device_ms": device_ms(backward(lib_out))}
    if hasattr(A, "flash_attn_bwd_cuda"):
        _, m, l = A.flash_attn_fwd_cuda(q, k, v, valid, scale,
                                        with_stats=True)
        args = (q, k, v, valid, d_out, out.detach(), m, l, scale)
        times["dq_role_device_ms"] = device_ms(
            lambda: A.flash_attn_bwd_cuda(*args, want_dkv=False))
        times["dkv_role_device_ms"] = device_ms(
            lambda: A.flash_attn_bwd_cuda(*args, want_dq=False))
    return times


def train_step_profile(device, steps: int = 3,
                       compute_dtype: str = "float32") -> dict:
    """Device operations and device ms per flagship training step at
    dropout 0 with flash attention, computing in ``compute_dtype``."""
    data = make_dataset(n_train=16, n_eval=2, min_len=255, max_len=256,
                        seed=0, device=device)
    with tempfile.TemporaryDirectory() as out_dir:
        cfg = TrainConfig(
            model=MODEL, d_model=512, d_ff=2048, n_heads=8, n_layers=6,
            loss="combined", optimizer="adam", lr_scheduling="noam",
            bucket_sizes=(256,), batch_size=8, max_seq_len=256, dropout=0.0,
            attention_impl="flash", drmsd_impl="cuda", sidechain_impl="cuda",
            log_structure_step=0, log_val_struct_step=0, out_dir=out_dir,
            name="bench-attention",
            **({} if compute_dtype == "float32"
               else {"compute_dtype": compute_dtype}))
        trainer = Trainer(cfg, device=device, data=data)
        gen = torch.Generator().manual_seed(0)
        params = trainer.init_params(gen)
        w = params["head.output_projection.weight"]
        params["head.output_projection.weight"] = (
            0.02 * torch.randn(w.shape, generator=gen)).to(device)
        state = trainer.state_from(params)
        batch = next(trainer.dm.train_batches(np.random.default_rng(0)))

        def step():
            nonlocal state
            state = trainer.train_step(state, batch)[0]

        step()
        on_device = device_records(step, steps)
    return {"batch": list(batch.seq.shape),
            "device_ops": sum(e.count for e in on_device) / steps,
            "device_ms": sum(e.self_device_time_total
                             for e in on_device) / 1e3 / steps}


def op_inputs(device, shape):
    """q, k, v (B, H, L, d_model / H) and the (B, L) valid mask of the JAX
    tool's op level, drawn as it draws them, and the softmax scale."""
    bsz, heads, length, d_model = shape
    dim = d_model // heads
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(size=(bsz, heads, length, dim))
                                .astype(np.float32)).to(device)
               for _ in range(3))
    n_valid = np.maximum(rng.integers(length // 2, length + 1, bsz), 1)
    valid = torch.from_numpy(
        np.arange(length)[None] < n_valid[:, None]).to(device)
    return q, k, v, valid, 1.0 / math.sqrt(dim)


def valid_rows_diff(a: torch.Tensor, b: torch.Tensor,
                    valid: torch.Tensor) -> float:
    """Largest |a - b| of two (B, H, L, D) outputs on the valid rows."""
    rows = valid[:, None, :, None]
    return float(torch.where(rows, (a - b).abs(), 0.0).max())


def valid_rows_grads(attend, q, k, v, valid) -> tuple:
    """Gradients in q, k and v of the sum of attend(q, k, v) over the valid
    rows."""
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = attend(*leaves)
    total = torch.where(valid[:, None, :, None], out, 0.0).sum()
    return torch.autograd.grad(total, leaves)


def grads_diff(got, want) -> float:
    """Largest |got - want| over every entry of paired gradients."""
    return max(float((a - b).abs().max()) for a, b in zip(got, want))


def chained_p50(step, first, sync, calls: int = WINDOW_CALLS,
                repeats: int = WINDOW_REPEATS) -> float:
    """Median ms per call of step(state) -> state by paired windows; each
    call takes the previous one's result, so a window's calls run in turn
    on the device. Each window starts from ``first`` after three untimed
    calls."""
    from protein_transformer_tpu_torch.tools.bench_ladder import (
        paired_samples, timed_window)
    state = [first]

    def run(n):
        for _ in range(n):
            state[0] = step(state[0])

    def window(n):
        state[0] = first
        run(3)
        sync()
        return timed_window(run, n, sync)

    return statistics.median(paired_samples(window, calls, repeats)) * 1e3


def bench_op(device, shapes=OP_SHAPES, calls: int = WINDOW_CALLS,
             repeats: int = WINDOW_REPEATS) -> list[dict]:
    """The op level: one row a shape."""
    from protein_transformer_tpu_torch.tools.bench_ladder import synchronizer
    sync = synchronizer(device)
    rows = []
    for shape in shapes:
        q, k, v, valid, scale = op_inputs(device, shape)

        def xla(q, k, v):
            return A.flash_self_attention_torch(q, k, v, valid,
                                                sm_scale=scale)

        def flash(q, k, v):
            return A.flash_self_attention(q, k, v, valid, sm_scale=scale)

        g_x, g_f = (valid_rows_grads(f, q, k, v, valid) for f in (xla, flash))
        bsz, heads, length, d_model = shape
        rows.append({
            "level": "op", "b": bsz, "h": heads, "l": length, "dm": d_model,
            "fwd_max_abs_diff": valid_rows_diff(xla(q, k, v), flash(q, k, v),
                                                valid),
            "grad_max_abs_diff": grads_diff(g_f, g_x),
            "grad_max_abs": max(float(g.abs().max()) for g in g_x),
            "xla_fwd_ms": chained_p50(lambda s: xla(s, k, v), q, sync, calls,
                                      repeats),
            "flash_fwd_ms": chained_p50(lambda s: flash(s, k, v), q, sync,
                                        calls, repeats),
            "xla_fwdbwd_ms": chained_p50(
                lambda s: valid_rows_grads(xla, s, k, v, valid)[0], q, sync,
                calls, repeats),
            "flash_fwdbwd_ms": chained_p50(
                lambda s: valid_rows_grads(flash, s, k, v, valid)[0], q,
                sync, calls, repeats)})
        del q, k, v, g_x, g_f
        release_memory()
    return rows


def eval_config(impl: str, b: int, length: int, d_model: int,
                n_layers: int, n_heads: int, out_dir: str) -> TrainConfig:
    """The JAX tool's eval-step configuration under ``attention_impl``."""
    return TrainConfig(
        model=MODEL, d_model=d_model, d_ff=4 * d_model, n_heads=n_heads,
        n_layers=n_layers, loss="lndrmsd", backbone_loss=True,
        optimizer="adam", lr_scheduling="noam", dropout=0.1,
        max_seq_len=length, bucket_sizes=(length,), batch_size=b,
        train_only=True, name=f"attnbench-{impl}", out_dir=out_dir,
        attention_impl=impl)


def bench_eval_step(device, b: int = 4, length: int = 500,
                    d_model: int = 1024, n_layers: int = 6, n_heads: int = 8,
                    calls: int = WINDOW_CALLS,
                    repeats: int = WINDOW_REPEATS) -> dict:
    """The eval level at one batch: ms per eval step with xla and with
    flash attention, and the largest difference of their packed metrics.
    Both trainers start from the same weights, drawn from one seed with a
    random output head (a zero head would predict the same angles under
    either attention)."""
    from protein_transformer_tpu_torch.tools.bench_ladder import (
        paired_samples, synchronizer, timed_window)
    sync = synchronizer(device)
    out = {"level": "eval_step", "b": b, "l": length, "dm": d_model}
    data = make_dataset(n_train=b, n_eval=2, min_len=length - 1,
                        max_len=length, seed=0, device=device)
    metrics = {}
    for impl in ("xla", "flash"):
        with tempfile.TemporaryDirectory() as out_dir:
            tr = Trainer(eval_config(impl, b, length, d_model, n_layers,
                                     n_heads, out_dir), device, data)
            gen = torch.Generator().manual_seed(0)
            params = tr.init_params(gen)
            w = params["head.output_projection.weight"]
            params["head.output_projection.weight"] = (
                0.02 * torch.randn(w.shape, generator=gen)).to(device)
            batch = collate(tr.dm.train, np.arange(b), tr.cfg.bucket_sizes,
                            tr.dm.max_seq_len,
                            batch_multiple=tr.dm.batch_multiple).to(device)
            metrics[impl] = tr.eval_step(params, batch).cpu()

            def run(n):
                for _ in range(n):
                    tr.eval_step(params, batch)

            def window(n):
                run(1)
                sync()
                return timed_window(run, n, sync)

            out[f"{impl}_eval_ms"] = statistics.median(
                paired_samples(window, calls, repeats)) * 1e3
            del tr, params, batch
            release_memory()
    out["speedup"] = out["xla_eval_ms"] / out["flash_eval_ms"]
    out["metrics_max_abs_diff"] = float(
        (metrics["xla"] - metrics["flash"]).abs().max())
    out["metrics_flash"] = unpack_metrics(metrics["flash"])
    return out


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--dtype", choices=["float32", "bfloat16"],
                        default="float32",
                        help="the kernel instance and the step's compute "
                             "dtype to time (the kernels level)")
    parser.add_argument("--level", choices=["kernels", "op", "eval", "all"],
                        default="kernels")
    args = parser.parse_args(argv)
    dtype = getattr(torch, args.dtype)
    device = cuda_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_label()
    print(f"# port at {A.__file__}, {args.dtype}")
    results = {"card": card, "dtype": args.dtype}
    if args.level in ("op", "all"):
        results["op"] = bench_op(device)
        for row in results["op"]:
            print(json.dumps({**row, "card": card}), flush=True)
    if args.level in ("eval", "all"):
        results["eval"] = [bench_eval_step(device, b) for b in EVAL_BATCHES]
        for row in results["eval"]:
            print(json.dumps({**row, "card": card}), flush=True)
    if args.level not in ("kernels", "all"):
        return results
    results["attention"] = {}
    for shape, mask in CASES:
        t = attention_times(device, shape, mask, dtype=dtype)
        results["attention"]["x".join(map(str, shape)) + " " + mask] = t
        roles = (f"; dQ role alone {t['dq_role_device_ms']:.4f} ms, dK/dV "
                 f"role alone {t['dkv_role_device_ms']:.4f} ms"
                 if "dq_role_device_ms" in t else "")
        print(f"attention {shape}, {mask} mask: K3a "
              f"{t['forward_device_ms']:.4f} ms ("
              f"{t['forward_stats_device_ms']:.4f} with m and l), library "
              f"forward {t['library_forward_device_ms']:.4f} ms, backward "
              f"{t['backward_device_ms']:.4f} ms "
              f"({t['backward_device_ops']:.0f} device operations: "
              f"{', '.join(t['backward_kernels'])}){roles}, library backward "
              f"{t['library_backward_device_ms']:.4f} ms, on the device "
              f"({card})")
    t = train_step_profile(device, compute_dtype=args.dtype)
    results["flash_train_step"] = t
    print(f"flash train step, B x L = {t['batch']}: "
          f"{t['device_ops']:.1f} device operations, "
          f"{t['device_ms']:.3f} ms of device time per step ({card})")
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()

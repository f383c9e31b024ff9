"""The port stands alone: it imports neither JAX nor the JAX package.

The machine the port runs on has no JAX, and the JAX package may come to
import jax from any of its modules, so the port keeps its own copies of that
package's numpy-only modules. The first test imports every module of the
port (its ``scripts`` among them), and ``chip_smoke``, in a fresh
interpreter in which importing jax, jaxlib, flax, optax, orbax or
protein_transformer_tpu raises. The second
holds the copies equal to the originals, name by name, so that they cannot
drift.
"""
import os
import subprocess
import sys
import types

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BLOCKED_IMPORTS = r'''
import importlib
import importlib.abc
import pkgutil
import sys

BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax",
           "protein_transformer_tpu")


class Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name in BLOCKED or name.startswith(tuple(b + "." for b in BLOCKED)):
            raise ImportError(f"the port must not import {name}")
        return None


sys.meta_path.insert(0, Blocker())
import protein_transformer_tpu_torch as pkg

names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                               pkg.__name__ + ".")]
assert len(names) > 20, names
# the wandb logging and the dataset tools, the scripts package, the
# multi-GPU modules, the FLOPs model, the scale-data tools, the config
# ladder and the trace tools, the analysis scripts, the reference-checkpoint
# import, the bench and its protocol, the spans
expected = {pkg.__name__ + "." + m for m in (
    "parallel.distributed", "parallel.mesh", "parallel.sharding",
    "training.wandb_logging", "protein.measure",
    "protein.structure_exceptions", "data.proteinnet", "data.convert",
    "data.align", "data.acquire", "scripts.proteinnet_to_dataset",
    "scripts.dataset_item_to_pdb", "scripts.export_embeddings_to_tsv",
    "training.flops", "tools.gen_scale_data", "tools.oracle_floor",
    "tools.stress_pipeline", "tools.gen_dev_data", "tools.bench_ladder",
    "tools.trace_ladder", "tools.analyze_trace", "tools.bench_attention",
    "scripts.compute_dataset_angle_means",
    "scripts.create_development_datasets", "scripts.downsample_dataset",
    "scripts.group_predictions", "scripts.analyze", "scripts.plot",
    "models.torch_import", "bench", "tools.bench_protocol", "tracing")}
assert expected <= set(names), expected - set(names)
for name in names + ["chip_smoke"]:
    importlib.import_module(name)
loaded = [m for m in sys.modules
          if m in BLOCKED or m.startswith(tuple(b + "." for b in BLOCKED))]
assert not loaded, loaded
print("imported", len(names) + 1)
'''


def test_port_and_chip_smoke_import_without_jax_or_the_jax_package():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", BLOCKED_IMPORTS], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("imported")


COPIES = ("protein.constants", "protein.vocab", "protein._ff14sb")


def public_values():
    """(module, name) of every public array and constant of the copies."""
    import importlib
    out = []
    for mod in COPIES:
        m = importlib.import_module(f"protein_transformer_tpu_torch.{mod}")
        for name, value in sorted(vars(m).items()):
            if name.startswith("_") or isinstance(
                    value, (types.ModuleType, type)) or callable(value):
                continue
            if name in ("annotations", "VOCAB"):
                continue
            out.append((mod, name))
    return out


@pytest.mark.parametrize("mod,name", public_values(),
                         ids=lambda v: v.split(".")[-1])
def test_copied_tables_equal_the_jax_packages(mod, name):
    import importlib
    ours = getattr(importlib.import_module(
        f"protein_transformer_tpu_torch.{mod}"), name)
    theirs = getattr(importlib.import_module(
        f"protein_transformer_tpu.{mod}"), name)
    if isinstance(ours, np.ndarray):
        assert ours.dtype == theirs.dtype
        assert np.array_equal(ours, theirs)
    else:
        assert ours == theirs


def test_copied_vocabulary_encodes_as_the_jax_packages():
    from protein_transformer_tpu.protein.vocab import VOCAB as theirs
    from protein_transformer_tpu_torch.protein.vocab import VOCAB as ours
    assert len(ours) == len(theirs)
    assert (ours.pad_id, ours.unk_id, ours.sos_id, ours.eos_id) == (
        theirs.pad_id, theirs.unk_id, theirs.sos_id, theirs.eos_id)
    seq = "ACDEFGHIKLMNPQRSTVWY_?XB<>"
    assert ours.str2ints(seq) == theirs.str2ints(seq)
    assert np.array_equal(ours.str2array(seq, add_sos_eos=True),
                          theirs.str2array(seq, add_sos_eos=True))
    assert ours.ints2str(range(22)) == theirs.ints2str(range(22))

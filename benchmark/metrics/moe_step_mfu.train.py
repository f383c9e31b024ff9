"""Model FLOP utilisation of the training window of an 'mla-moe' cell:
``moonlight_flops`` at each protein's real length, three times the
forward, over (the window's seconds x the bf16 dense peak), in %."""
from benchmark import moonlight_flops as MF
from benchmark.frozen import flops as F


def read(run):
    s = run.stretch
    if run.kind != "train" or not run.on_card or "mla_moe" not in run.config \
            or not s.steps or len(s.lens) != s.steps:
        return None
    flops = sum(MF.train_flops_real(run.config, lens) for lens in s.lens)
    return 100.0 * flops / (s.seconds * F.peak_bf16(run.device_name))

"""Turn a JAX training run's state into the PyTorch port's resume pair.

    python scripts/torch_import_jax_state.py --state_dir checkpoints/step_N \
        --npz checkpoints/densecap.npz --output checkpoints/densecap_torch

Runs where JAX, optax and orbax are installed (not on the GPU machine);
the port never imports it. Reads the JAX train CLI's orbax TrainState
(`densecap_tpu/cli/train.py` writes it at dirname(--checkpoint_path)/
step_N) and the `.npz` beside it, whose meta holds the model's config.
Writes `<output>.npz` and `<output>.optim.pt`, which
`python -m densecap_tpu_torch.cli.train --checkpoint_start_from <output>`
resumes.

The JAX optimizer is chain(multi_transform({frozen, cnn, main}),
scale_by_learning_rate) (`densecap_tpu/parallel/train_step.py`):

  * parameters go through the `.npz` layout (HWIO conv kernels become
    OIHW, as `utils.checkpoint.to_torch` does);
  * each zone's Adam moments mu / nu become torch's exp_avg / exp_avg_sq
    in the same layout, with the zone's count as their step; the cnn zone
    gets state only when its count is above 0 (before the finetune flip
    torch's Adam has none for trunk2, which is JAX's fresh zone);
  * the schedule's count becomes `Trainer.count` (the step, with a
    constant learning rate), state.step the iteration and
    state.finetune_cnn the finetune flag.

The JAX CLI saves its state with the vocabulary padding stripped, so
nothing is unpadded here. The orbax template is the JAX `init_state` at
the `.npz`'s config; give the JAX run's --cosine_decay_steps, which
decides whether the state holds a schedule count. The learning rate and
Adam's betas and epsilon are not part of the state: the resumed train
CLI takes them from its own flags, as the JAX CLI does.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--state_dir", required=True,
                   help="the orbax TrainState directory (.../step_N)")
    p.add_argument("--npz", required=True,
                   help="the JAX run's checkpoint .npz (config in its meta)")
    p.add_argument("--output", required=True,
                   help="prefix of the pair to write")
    p.add_argument("--cosine_decay_steps", type=int, default=-1,
                   help="the JAX run's; > 0: its state holds a schedule "
                        "count")
    return p


def convert(args):
    """-> (Trainer over the imported CPU model, iteration, meta json)."""
    import jax
    import numpy as np
    import optax

    from densecap_tpu.config import DenseCapConfig as JaxConfig
    from densecap_tpu.parallel import train_step as jts
    from densecap_tpu.utils import checkpoint as jckpt
    from densecap_tpu_torch.config import DenseCapConfig
    from densecap_tpu_torch.utils.checkpoint import load_params

    _, extra = load_params(args.npz)
    meta = str(extra["meta"])
    config = json.loads(meta)["config"]
    # only the template's structure counts: a schedule keeps a count
    jax_lr = (optax.constant_schedule(1e-5) if args.cosine_decay_steps > 0
              else 1e-5)
    template, _ = jts.init_state(jax.random.PRNGKey(0),
                                 JaxConfig.from_json(config),
                                 learning_rate=jax_lr)
    state = jckpt.load_train_state(args.state_dir, template)
    params = jax.tree_util.tree_map(np.asarray, state.params)

    trainer = trainer_from_jax(
        params, state.opt_state, DenseCapConfig.from_json(config),
        int(state.step), bool(state.finetune_cnn))
    return trainer, int(state.step), meta


def trainer_from_jax(params, opt_state, cfg, step, finetune_cnn,
                     learning_rate=1e-5):
    """A port Trainer over a CPU model of `params` (a numpy tree) that
    holds the JAX optimizer state `opt_state` (`train_step.make_optimizer`'s:
    each zone's Adam count and moments, and the schedule's count when
    the learning rate is a schedule; `step` stands in for it otherwise)."""
    import torch
    from optax.transforms import MaskedNode

    from densecap_tpu_torch.parallel.train_step import Trainer, param_zones
    from densecap_tpu_torch.utils.checkpoint import to_torch

    def as_model(tree):
        return dict(to_torch(tree, cfg, "cpu", train=True).named_parameters())

    model = to_torch(params, cfg, "cpu", train=True)
    trainer = Trainer(model, learning_rate=learning_rate)
    zones = param_zones(model)
    partition, schedule = opt_state
    for zone in ("main", "cnn"):
        adam = partition.inner_states[zone].inner_state
        count = int(adam.count)
        if count == 0:
            continue
        # masked groups (other zones) take the parameters' shapes only
        mu, nu = (as_model({k: params[k] if isinstance(m[k], MaskedNode)
                            else m[k] for k in params})
                  for m in (adam.mu, adam.nu))
        for name, p in model.named_parameters():
            if zones[name] == zone:
                trainer.opt.state[p] = {
                    "step": torch.tensor(float(count)),
                    "exp_avg": mu[name].detach().clone(),
                    "exp_avg_sq": nu[name].detach().clone()}
    trainer.count = int(getattr(schedule, "count", step))
    trainer.set_finetune(finetune_cnn)
    return trainer


def main(argv=None):
    args = build_argparser().parse_args(argv)
    from densecap_tpu_torch.utils.checkpoint import save_train_state

    trainer, it, meta = convert(args)
    save_train_state(args.output, trainer, it, meta)
    print(f"wrote {args.output}.npz and {args.output}.optim.pt: iteration "
          f"{it}, schedule count {trainer.count}, finetune_cnn "
          f"{trainer.finetune_cnn}")


if __name__ == "__main__":
    main()

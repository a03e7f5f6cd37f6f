"""Tutorial: fit a GaussianMLP ensemble to a noisy 1-D function (counterpart
of ``mbrl_tpu/examples/tutorial_fit_ensemble_1d.py``).

Script-form equivalent of the reference's ``notebooks/fit_gaussian_mlp_ensemble_1d.ipynb``:
train a 5-member probabilistic ensemble on y = sin(x) with input-dependent noise and
separate the epistemic uncertainty (variance of member means, shrinks with data) from
the aleatoric uncertainty (predicted variance, tracks the injected noise level).

Run: ``python -m mbrl_tpu_torch.examples.tutorial_fit_ensemble_1d [--epochs 500] [--device cpu]``
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from mbrl_tpu_torch.device import DeviceLike
from mbrl_tpu_torch.models import GaussianMLP, ModelTrainer, TransitionRewardModel
from mbrl_tpu_torch.ops.normalizer import normalize
from mbrl_tpu_torch.util.common import get_basic_buffer_iterators
from mbrl_tpu_torch.util.replay_buffer import ReplayBuffer


def make_data(rng: np.random.Generator, train_size: int = 2000, val_size: int = 200):
    """sin(x) on [-12, 12]; half the samples with sigma=0.05 noise on x<0, half with
    sigma=0.20 on x>0 (the notebook's heteroscedastic setup)."""

    def sample(n, lo, hi, sigma):
        x = rng.uniform(lo, hi, size=n)
        y = np.sin(x) + sigma * rng.standard_normal(n)
        return x, y

    x1, y1 = sample(train_size, -12.0, 0.0, 0.05)
    x2, y2 = sample(train_size, 0.0, 12.0, 0.20)
    xv1, yv1 = sample(val_size, -12.0, 0.0, 0.05)
    xv2, yv2 = sample(val_size, 0.0, 12.0, 0.20)
    return (
        np.concatenate([x1, x2]),
        np.concatenate([y1, y2]),
        np.concatenate([xv1, xv2]),
        np.concatenate([yv1, yv2]),
    )


def main(num_epochs: int = 500, seed: int = 0, plot: bool = False,
         device: DeviceLike = "cuda") -> float:
    rng = np.random.default_rng(seed)
    x_train, y_train, x_val, y_val = make_data(rng)

    # The model is trained as a "dynamics" model obs->next_obs with a 1-D obs and
    # 0-D action: store (x, y) pairs in a replay buffer with target_is_delta=False.
    buffer = ReplayBuffer(
        len(x_train) + len(x_val), obs_shape=(1,), action_shape=(0,), rng=rng
    )
    for x, y in zip(x_train, y_train):
        buffer.add(np.array([x]), np.zeros(0), np.array([y]), 0.0, False, False)
    for x, y in zip(x_val, y_val):
        buffer.add(np.array([x]), np.zeros(0), np.array([y]), 0.0, False, False)

    num_members = 5
    model = GaussianMLP(
        in_size=1,
        out_size=1,
        num_layers=3,
        ensemble_size=num_members,
        hid_size=64,
        activation="silu",
        device=device,
    )
    wrapper = TransitionRewardModel(
        model, target_is_delta=False, normalize=True, learned_rewards=False
    )
    state = wrapper.init(torch.Generator().manual_seed(seed))
    state = wrapper.update_normalizer(state, buffer.get_all())

    train_iter, val_iter = get_basic_buffer_iterators(
        buffer,
        batch_size=256,
        val_ratio=len(x_val) / (len(x_train) + len(x_val)),
        ensemble_size=num_members,
        shuffle_each_epoch=True,
    )
    trainer = ModelTrainer(wrapper, optim_lr=1e-3, weight_decay=5e-5)
    state, train_losses, val_scores = trainer.train(
        state, train_iter, val_iter, num_epochs=num_epochs, patience=100
    )
    print(
        f"final train loss {train_losses[-1]:.4f}, "
        f"best val score {np.asarray(val_scores).min():.5f}"
    )

    # predict over the full range; epistemic = var of member means, aleatoric =
    # mean predicted variance
    x_all = np.linspace(-12, 12, 1000, dtype=np.float32)[:, None]
    with torch.no_grad():
        x_norm = normalize(state["normalizer"], torch.as_tensor(x_all, device=model.device))
        mean, logvar = model.forward(state["params"], x_norm.float())
    mean = mean.cpu().numpy()[..., 0]
    var_epistemic = mean.var(axis=0)
    var_aleatoric = np.exp(logvar.cpu().numpy())[..., 0].mean(axis=0)
    pred = mean.mean(axis=0)

    rmse = float(np.sqrt(np.mean((pred - np.sin(x_all[:, 0])) ** 2)))
    left = var_aleatoric[x_all[:, 0] < 0].mean()
    right = var_aleatoric[x_all[:, 0] > 0].mean()
    print(
        f"RMSE vs sin(x): {rmse:.4f} | aleatoric var left {left:.4f} "
        f"vs right {right:.4f} (injected 0.0025 vs 0.04)"
    )

    if plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        std = np.sqrt(var_epistemic + var_aleatoric)
        plt.figure(figsize=(16, 8))
        plt.plot(x_all[:, 0], np.sin(x_all[:, 0]), "k", label="sin(x)")
        plt.plot(x_all[:, 0], pred, "r", label="ensemble mean")
        plt.fill_between(
            x_all[:, 0], pred - 2 * std, pred + 2 * std, alpha=0.2, label="±2 std"
        )
        plt.scatter(x_train[::20], y_train[::20], s=4, alpha=0.3, label="train data")
        plt.legend()
        plt.savefig("fit_ensemble_1d.png", bbox_inches="tight")
        print("saved fit_ensemble_1d.png")

    return rmse


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--epochs", type=int, default=500)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--plot", action="store_true")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args()
    main(args.epochs, args.seed, plot=args.plot, device=args.device)

"""Tutorial: the CEM optimizer on the (negated) Rosenbrock function
(counterpart of ``mbrl_tpu/examples/tutorial_cem_rosenbrock.py``).

Script-form equivalent of the reference's ``notebooks/cem_rosenbrock_ex.ipynb``:
run ``CEMOptimizer`` standalone on an arbitrary objective (no model, no env) and
plot per-iteration population statistics.

Run: ``python -m mbrl_tpu_torch.examples.tutorial_cem_rosenbrock [--iterations 100] [--device cpu]``
"""
from __future__ import annotations

import argparse

import torch

from mbrl_tpu_torch.device import DeviceLike
from mbrl_tpu_torch.planning import CEMOptimizer


def neg_rosenbrock(x_array: torch.Tensor, a: float = 1.0, b: float = 100.0) -> torch.Tensor:
    """Negated Rosenbrock on pairs of coordinates; maximum 0 at (1, 1, ...).

    ``x_array``: population shaped (P, H, D) with H*D even; returns (P,) values.
    """
    flat = x_array.reshape(x_array.shape[0], -1)
    x = flat[:, 0::2]
    y = flat[:, 1::2]
    return -(torch.square(a - x) + b * torch.square(y - torch.square(x))).sum(dim=-1)


def main(
    iterations: int = 100,
    population_size: int = 500,
    elite_ratio: float = 0.1,
    seed: int = 0,
    plot: bool = False,
    device: DeviceLike = "cuda",
) -> float:
    lb = [[-2.0, -2.0]]
    ub = [[2.0, 2.0]]
    opt = CEMOptimizer(
        num_iterations=iterations,
        elite_ratio=elite_ratio,
        population_size=population_size,
        lower_bound=lb,
        upper_bound=ub,
        alpha=0.1,
        device=device,
    )

    # per-iteration population stats via the optimizer callback (kept on the
    # device; read once at the end)
    max_values: list = []
    mean_values: list = []

    def callback(population, values, iteration):
        max_values.append(values.max())
        mean_values.append(values.mean())

    x0 = torch.zeros((1, 2), device=opt.device)
    best, _ = opt.optimize(
        neg_rosenbrock, x0, torch.Generator().manual_seed(seed), callback=callback
    )
    best_value = float(neg_rosenbrock(best.reshape(1, 1, 2))[0])
    best = best.cpu().numpy().reshape(-1)
    print(f"best x = {best}, objective = {best_value:.5f} (optimum 0 at [1, 1])")

    if plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.figure(figsize=(12, 8))
        plt.plot(torch.stack(max_values).cpu().numpy(), label="Current iter. max")
        plt.plot(torch.stack(mean_values).cpu().numpy(), label="Current iter. mean")
        plt.axhline(best_value, color="k", ls="-.", label="Historic max")
        plt.axhline(0.0, color="r", ls="--", label="Optimal value")
        plt.xlabel("CEM iteration")
        plt.ylabel("objective")
        plt.legend()
        plt.savefig("cem_rosenbrock.png", bbox_inches="tight")
        print("saved cem_rosenbrock.png")

    return best_value


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--iterations", type=int, default=100)
    parser.add_argument("--population_size", type=int, default=500)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--plot", action="store_true")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args()
    main(args.iterations, args.population_size, seed=args.seed, plot=args.plot,
         device=args.device)

"""DatasetEvaluator: ground-truth-vs-prediction scatter plots per output
dimension (counterpart of ``mbrl_tpu/diagnostics/eval_model_on_dataset.py``).

Capability parity with the reference ``mbrl/diagnostics/eval_model_on_dataset.py``
(DatasetEvaluator:17-125): loads a saved model + replay buffer from a results dir,
runs the model over the whole dataset, and saves one scatter plot (truth vs each
ensemble member's prediction) per output dimension.

The prediction pass (:meth:`DatasetEvaluator.predict`) runs on the model's
device and returns numpy arrays; ``matplotlib`` is imported only to draw them.
"""
from __future__ import annotations

import argparse
import pathlib
from typing import Optional, Tuple

import numpy as np
import torch

from mbrl_tpu_torch.config import Config
from mbrl_tpu_torch.device import DeviceLike
from mbrl_tpu_torch.diagnostics.common import load_experiment
from mbrl_tpu_torch.util import common as util_common
from mbrl_tpu_torch.util.replay_buffer import TransitionIterator


class DatasetEvaluator:
    def __init__(self, model_dir: str, dataset_dir: str, output_dir: str, *,
                 cfg: Optional[Config] = None, device: DeviceLike = "cuda"):
        self.model_path = pathlib.Path(model_dir)
        self.output_path = pathlib.Path(output_dir)
        self.output_path.mkdir(parents=True, exist_ok=True)

        cfg, env, self.dynamics_model, self.model_state, _, *_ = load_experiment(
            model_dir, load_buffer=False, cfg=cfg, device=device
        )
        self.cfg = cfg
        self.replay_buffer = util_common.create_replay_buffer(
            cfg, env.observation_space.shape, env.action_space.shape,
            load_dir=dataset_dir,
        )

    def predict(self, dataset: TransitionIterator) -> Tuple[np.ndarray, np.ndarray]:
        """Every member's predicted mean over the dataset, ``(E, N, out)``, and
        the targets, ``(N, out)``, in the dataset's order."""
        all_means = []
        all_targets = []
        with torch.no_grad():
            for batch in dataset:
                model_in, target = self.dynamics_model.process_batch(self.model_state, batch)
                mean, _ = self.dynamics_model.model.forward(self.model_state["params"], model_in)
                all_means.append(mean.cpu().numpy())  # (E, B, out)
                all_targets.append(target.cpu().numpy())
        return np.concatenate(all_means, axis=1), np.concatenate(all_targets, axis=0)

    def plot_dataset_results(self, dataset: TransitionIterator) -> None:
        self.plot(*self.predict(dataset))

    def plot(self, means: np.ndarray, targets: np.ndarray) -> None:
        """One ``pred_dim<d>.png`` per output dimension."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        num_dims = targets.shape[-1]
        for dim in range(num_dims):
            sort_idx = np.argsort(targets[:, dim])
            truth = targets[sort_idx, dim]
            fig, ax = plt.subplots(figsize=(8, 6))
            ax.plot(truth, truth, "k--", linewidth=1, label="truth")
            for e in range(means.shape[0]):
                ax.plot(
                    truth, means[e, sort_idx, dim], ".", markersize=2,
                    alpha=0.5, label=f"member {e}",
                )
            ax.set_title(f"Output dimension {dim}")
            ax.legend(markerscale=4, fontsize=7)
            fig.savefig(self.output_path / f"pred_dim{dim}.png", dpi=120)
            plt.close(fig)

    def dataset(self) -> TransitionIterator:
        """The whole buffer in batches of 32, each row once (the buffer's own
        shuffle)."""
        dataset, _ = util_common.get_basic_buffer_iterators(
            self.replay_buffer, 32, 0, ensemble_size=1, shuffle_each_epoch=False
        )
        dataset.toggle_bootstrap()
        return dataset

    def run(self) -> None:
        self.plot_dataset_results(self.dataset())


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_dir", type=str, required=True)
    parser.add_argument("--dataset_dir", type=str, default=None)
    parser.add_argument("--results_dir", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args()
    evaluator = DatasetEvaluator(
        args.model_dir,
        args.dataset_dir or args.model_dir,
        args.results_dir or (args.model_dir + "/diagnostics"),
        device=args.device,
    )
    evaluator.run()

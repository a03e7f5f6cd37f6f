"""PlaNet visualizer: side-by-side video of real pixels vs. open-loop RSSM
predictions (counterpart of ``mbrl_tpu/diagnostics/planet_visualizer.py``).

Capability parity with the reference ``mbrl/diagnostics/planet_visualizer.py``
(PlanetVisualizer:23-184): load a trained PlaNet run, act in the real env with the
latent CEM agent for ``start_step + lookahead`` steps, then replay the recorded
action sequence open-loop through the learned PRIOR starting from the posterior at
``start_step``, decode every imagined latent to pixels, and write a
``pred | true`` comparison GIF (``.gif.npz`` of the frames without ``imageio``)
plus the true vs. predicted total reward.

As in the JAX package, the posterior is conditioned per real step exactly as in
training, the replay starts from the posterior tracked at ``start_step``, and
all imagined frames are decoded in one batch. The acting, the replay and the
decoding (:meth:`PlanetVisualizer.compute`) run on ``device``.
"""
from __future__ import annotations

import argparse
import pathlib
from typing import Any, Dict, Optional

import numpy as np
import torch

from mbrl_tpu_torch.config import Config, complete_agent_cfg, instantiate
from mbrl_tpu_torch.device import DeviceLike
from mbrl_tpu_torch.diagnostics.common import load_run_config
from mbrl_tpu_torch.envs.termination_fns import no_termination
from mbrl_tpu_torch.models import ModelEnv
from mbrl_tpu_torch.planning import create_trajectory_optim_agent_for_model
from mbrl_tpu_torch.util.env import create_handler


class PlanetVisualizer:
    def __init__(
        self,
        start_step: int,
        lookahead: int,
        model_dir: str,
        seed: int = 0,
        num_iterations: int = 10,
        population_size: int = 1000,
        planning_horizon: int = 12,
        env=None,
        *,
        cfg: Optional[Config] = None,
        device: DeviceLike = "cuda",
    ):
        self.start_step = start_step
        self.lookahead = lookahead
        self.seed = seed
        self.model_dir = pathlib.Path(model_dir)
        self.vis_dir = self.model_dir / "diagnostics"
        self.vis_dir.mkdir(parents=True, exist_ok=True)

        self.cfg = load_run_config(model_dir) if cfg is None else cfg
        if env is None:
            handler = create_handler(self.cfg)
            env, _, _ = handler.make_env(self.cfg)
        self.env = env

        self.cfg.dynamics_model["action_size"] = self.env.action_space.shape[0]
        self.planet = instantiate(self.cfg.dynamics_model, device=device)
        self.planet_state = self.planet.init(torch.Generator().manual_seed(seed))
        self.planet_state = self.planet.load(self.planet_state, self.model_dir)
        self.model_env = ModelEnv(self.planet, no_termination, None)

        # latent-space CEM agent with the reference visualizer's planner settings
        # (planet_visualizer.py:78-98): CEM 10 iters x pop 1000, horizon 12,
        # replan_freq 1, mean-of-elites
        agent_cfg = complete_agent_cfg(
            self.env,
            Config({
                "_target_": "mbrl_tpu_torch.planning.TrajectoryOptimizerAgent",
                "action_lb": "???",
                "action_ub": "???",
                "planning_horizon": planning_horizon,
                "optimizer": {
                    "_target_": "mbrl_tpu_torch.planning.CEMOptimizer",
                    "num_iterations": num_iterations,
                    "elite_ratio": 0.1,
                    "population_size": population_size,
                    "alpha": 0.1,
                    "lower_bound": "???",
                    "upper_bound": "???",
                    "return_mean_elites": True,
                },
                "replan_freq": 1,
                "keep_last_solution": False,
                "verbose": True,
            }),
            device=device,
        )
        self.agent = instantiate(agent_cfg, seed=seed + 1)
        self.agent = create_trajectory_optim_agent_for_model(
            self.model_env, self.agent
        )

    def compute(self) -> Dict[str, Any]:
        """Act, then replay the actions from ``start_step`` through the prior.
        Returns the true frames and actions from ``start_step`` on, the
        replay's latents and beliefs (``(n + 1, latent)``, ``(n + 1, belief)``,
        on the device), the decoded frames ``(n + 1, H, W, C)`` uint8, and
        the true and predicted total rewards."""
        generator = torch.Generator().manual_seed(self.seed)
        true_obs: list = []
        actions: list = []
        true_total_reward = 0.0
        snapshot_state = None

        obs, _ = self.env.reset(seed=self.seed)
        self.agent.reset()
        state = self.planet.reset_posterior(self.planet_state)
        action = None
        for step in range(self.start_step + self.lookahead):
            state = self.planet.update_posterior(state, obs, action=action, generator=generator)
            self.agent.set_eval_state(state)
            if step == self.start_step:
                snapshot_state = state
            action = np.clip(
                np.asarray(self.agent.act(obs)), -1.0, 1.0
            ).astype(self.env.action_space.dtype)
            next_obs, reward, terminated, truncated, _ = self.env.step(action)
            if step >= self.start_step:
                true_obs.append(np.asarray(obs))
                actions.append(action)
                true_total_reward += float(reward)
            obs = next_obs
            if terminated or truncated:
                break
        if snapshot_state is None:
            snapshot_state = state

        # open-loop prior replay from the start_step posterior (batch of 1)
        model_state = {
            "latent": snapshot_state["posterior"]["latent"],
            "belief": snapshot_state["posterior"]["belief"],
        }
        latents = [model_state["latent"]]
        beliefs = [model_state["belief"]]
        rewards = []
        with torch.no_grad():
            for a in actions:
                act = torch.as_tensor(a, dtype=torch.float32,
                                      device=self.planet.device).reshape(1, -1)
                _, reward, model_state = self.planet.sample(
                    snapshot_state, act, model_state, generator
                )
                rewards.append(reward.reshape(-1)[0])
                latents.append(model_state["latent"])
                beliefs.append(model_state["belief"])
        latents, beliefs = torch.cat(latents), torch.cat(beliefs)
        # decode all imagined frames in one batch
        pred_imgs = self.planet.render(snapshot_state, latents, beliefs)
        pred_total_reward = float(torch.stack(rewards).sum().item()) if rewards else 0.0
        return {"true_obs": true_obs, "actions": actions, "latents": latents,
                "beliefs": beliefs, "pred_imgs": pred_imgs,
                "true_total_reward": true_total_reward, "pred_total_reward": pred_total_reward}

    def run(self) -> pathlib.Path:
        result = self.compute()
        print(
            f"True total reward: {result['true_total_reward']}. "
            f"Predicted total reward: {result['pred_total_reward']}"
        )
        return self.write(result["true_obs"], result["pred_imgs"])

    def write(self, true_obs, pred_imgs: np.ndarray) -> pathlib.Path:
        """The ``pred | true`` frames as a GIF (``.gif.npz`` without
        ``imageio``); returns the path written."""
        frames = []
        for idx in range(min(self.lookahead, len(true_obs))):
            true_img = true_obs[idx]
            if true_img.ndim == 3 and true_img.shape[0] in (1, 3):  # CHW -> HWC
                true_img = true_img.transpose(1, 2, 0)
            true_img = true_img.astype(np.uint8)
            pred_img = pred_imgs[idx]
            if pred_img.shape != true_img.shape:
                # a decoder whose deconv stack doesn't land exactly on the env
                # frame size (possible with custom decoder_config) — crop/pad to
                # the true frame so the side-by-side still renders
                canvas = np.zeros_like(true_img)
                h = min(pred_img.shape[0], true_img.shape[0])
                w = min(pred_img.shape[1], true_img.shape[1])
                c = min(pred_img.shape[2], true_img.shape[2])
                canvas[:h, :w, :c] = pred_img[:h, :w, :c]
                pred_img = canvas
            frames.append(np.concatenate([pred_img, true_img], axis=1))

        out = (
            self.vis_dir
            / f"visualization_{self.start_step}_{self.lookahead}_{self.seed}.gif"
        )
        try:
            import imageio

            imageio.mimsave(str(out), frames, fps=10)
        except Exception:
            out = pathlib.Path(str(out) + ".npz")
            np.savez_compressed(str(out), frames=np.stack(frames))
        print(f"Saved visualization to {out}")
        return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "--model_dir",
        type=str,
        required=True,
        help="The directory where the PlaNet run was saved.",
    )
    parser.add_argument("--lookahead", type=int, default=50)
    parser.add_argument("--start_step", type=int, default=0)
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args()
    PlanetVisualizer(
        args.start_step, args.lookahead, args.model_dir, seed=args.seed, device=args.device
    ).run()

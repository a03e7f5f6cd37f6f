"""Model packaging and Hugging Face Hub integration (counterpart of
``mbrl_tpu/util/huggingface.py``).

Capability parity with the reference ``mbrl/util/huggingface.py:42-556``
(package_to_hub, push_to_hub, load_model_from_hub, load_agent_from_hub, model-card
generation, eval + video for the card). The packaging layer is fully local (works
offline); hub upload/download delegate to ``huggingface_hub``, imported when one
of them is called, and need network access.
"""
from __future__ import annotations

import json
import pathlib
import pickle
import shutil
import tempfile
from typing import Any, Dict, Optional

import numpy as np
import torch

from mbrl_tpu_torch.config import Config
from mbrl_tpu_torch.device import DeviceLike
from mbrl_tpu_torch.diagnostics.common import load_run_config
from mbrl_tpu_torch.ops.tree import tree_map

LIBRARY = "mbrl_tpu_torch"


def _render_card(
    algo: str,
    env_name: str,
    mean_reward: float,
    std_reward: float,
    has_video: bool,
    extra_metrics: Optional[dict] = None,
) -> str:
    """Model card with Hub `model-index` metadata (drives the leaderboard —
    reference mbrl/util/huggingface.py:90-111 uses metadata_eval_result the same
    way), a metrics table, and an embedded eval video when one was recorded."""
    have_eval = mean_reward == mean_reward  # not NaN
    reward_str = f"{mean_reward:.2f} +/- {std_reward:.2f}"
    meta = [
        "---",
        "tags:",
        "- model-based-reinforcement-learning",
        "- reinforcement-learning",
        "- mbrl-tpu",
        f"- {algo}",
        f"- {env_name}",
        f"library_name: {LIBRARY}",
    ]
    if have_eval:
        meta += [
            "model-index:",
            f"- name: {algo}-{env_name}",
            "  results:",
            "  - task:",
            "      type: reinforcement-learning",
            "      name: reinforcement-learning",
            "    dataset:",
            f"      name: {env_name}",
            f"      type: {env_name}",
            "    metrics:",
            "    - type: mean_reward",
            f"      value: {reward_str}",
            "      name: mean_reward",
            "      verified: false",
        ]
    meta.append("---")
    body = [
        "",
        f"# {algo.upper()} agent for {env_name}",
        "",
        f"This is a trained model produced by **{LIBRARY}**, the PyTorch/CUDA",
        "port of mbrl_tpu, a model-based reinforcement learning framework with the",
        "capabilities of facebookresearch/mbrl-lib.",
        "",
        "| | |",
        "|---|---|",
        f"| Algorithm | {algo} |",
        f"| Environment | {env_name} |",
    ]
    if have_eval:
        body.append(f"| Mean reward (eval) | {reward_str} |")
    for k, v in (extra_metrics or {}).items():
        body.append(f"| {k} | {v} |")
    if has_video:
        body += [
            "",
            "## Replay",
            "",
            '<video src="replay.mp4" controls autoplay muted loop></video>',
        ]
    body += [
        "",
        "## Usage",
        "",
        "```python",
        f"from {LIBRARY}.util.huggingface import load_model_from_package",
        'payload = load_model_from_package("path/to/package")',
        "```",
        "",
    ]
    return "\n".join(meta + body)


def evaluate_agent(env, agent, num_episodes: int = 5, video_recorder=None):
    """Mean/std episode reward (optionally recording the first episode)."""
    rewards = []
    for ep in range(num_episodes):
        obs, _ = env.reset()
        if video_recorder is not None:
            video_recorder.init(enabled=(ep == 0))
        done = trunc = False
        total = 0.0
        while not (done or trunc):
            action = agent.act(obs)
            obs, r, done, trunc, _ = env.step(action)
            total += r
            if video_recorder is not None:
                video_recorder.record(env)
        rewards.append(total)
    return float(np.mean(rewards)), float(np.std(rewards))


def package_experiment(
    results_dir,
    output_dir,
    env=None,
    agent=None,
    num_eval_episodes: int = 5,
    record_video: bool = False,
) -> pathlib.Path:
    """Bundle a results dir into a self-contained package directory: model +
    normalizer stats + config + model card (+ eval stats and video when an env and
    agent are provided)."""
    results_dir = pathlib.Path(results_dir)
    output_dir = pathlib.Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)

    for fname in ("model.pkl", "planet.pkl", "env_stats.pickle", "config.yaml", "sac.pkl"):
        src = results_dir / fname
        if src.exists():
            shutil.copy(src, output_dir / fname)

    cfg = load_run_config(results_dir)
    algo = cfg.get("algorithm", Config()).get("name", "unknown")
    env_name = cfg.get("overrides", Config()).get("env", "unknown")

    mean_reward, std_reward = float("nan"), float("nan")
    if env is not None and agent is not None:
        video_recorder = None
        if record_video:
            from mbrl_tpu_torch.util.video import VideoRecorder

            video_recorder = VideoRecorder(output_dir)
        mean_reward, std_reward = evaluate_agent(
            env, agent, num_eval_episodes, video_recorder
        )
        if video_recorder is not None:
            video_recorder.save("replay.mp4")

    card = _render_card(
        algo,
        env_name,
        mean_reward,
        std_reward,
        has_video=(output_dir / "video" / "replay.mp4").exists()
        or (output_dir / "replay.mp4").exists(),
    )
    (output_dir / "README.md").write_text(card)
    (output_dir / "metadata.json").write_text(
        json.dumps(
            {
                "algorithm": algo,
                "env": env_name,
                "mean_reward": mean_reward,
                "std_reward": std_reward,
                "library": LIBRARY,
            },
            indent=2,
        )
    )
    return output_dir


def load_model_from_package(package_dir, *, cfg: Optional[Config] = None,
                            device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Load a packaged experiment: returns {"cfg", "model", "state"} ready to
    use, the model on ``device``."""
    from mbrl_tpu_torch.config import create_one_dim_tr_model, instantiate

    package_dir = pathlib.Path(package_dir)
    cfg = load_run_config(package_dir) if cfg is None else cfg

    if (package_dir / "planet.pkl").exists():
        model = instantiate(cfg.dynamics_model, device=device)
        state = model.init(torch.Generator().manual_seed(0))
        state = model.load(state, package_dir)
        return {"cfg": cfg, "model": model, "state": state}

    # infer shapes from the config-completed model node, falling back to the
    # saved weights themselves (configs snapshotted before size-completion keep ???)
    in_size = cfg.dynamics_model.get("in_size")
    out_size = cfg.dynamics_model.get("out_size")
    if "member_cfg" in cfg.dynamics_model:
        in_size = cfg.dynamics_model.member_cfg.get("in_size")
        out_size = cfg.dynamics_model.member_cfg.get("out_size")
    learned_rewards = cfg.algorithm.get("learned_rewards", True)
    if in_size is None or out_size is None:
        with open(package_dir / "model.pkl", "rb") as f:
            payload = pickle.load(f)
        params = payload["params"]
        if "members" in params:
            params = tree_map(lambda x: x[0], params["members"])
        in_size = int(np.shape(params["layers"][0]["w"])[-2])
        head_out = int(np.shape(params["head"]["w"])[-1])
        deterministic = cfg.dynamics_model.get("deterministic", False)
        out_size = head_out if deterministic else head_out // 2
    obs_dim = out_size - int(bool(learned_rewards))
    act_dim = in_size - obs_dim
    wrapper = create_one_dim_tr_model(cfg, (obs_dim,), (act_dim,), device=device)
    state = wrapper.init(torch.Generator().manual_seed(0))
    state = wrapper.load(state, package_dir)
    return {"cfg": cfg, "model": wrapper, "state": state}


def push_to_hub(package_dir, repo_id: str, token: Optional[str] = None) -> str:
    """Upload a package to the Hugging Face Hub (requires network access)."""
    from huggingface_hub import HfApi

    api = HfApi(token=token)
    api.create_repo(repo_id=repo_id, exist_ok=True)
    api.upload_folder(repo_id=repo_id, folder_path=str(package_dir))
    return f"https://huggingface.co/{repo_id}"


def package_to_hub(
    results_dir,
    repo_id: str,
    env=None,
    agent=None,
    token: Optional[str] = None,
    **package_kwargs,
) -> str:
    """package_experiment + push_to_hub in one call (reference huggingface.py:42)."""
    with tempfile.TemporaryDirectory() as tmp:
        package_experiment(results_dir, tmp, env=env, agent=agent, **package_kwargs)
        return push_to_hub(tmp, repo_id, token=token)


def load_model_from_hub(repo_id: str, token: Optional[str] = None, *,
                        device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Download a packaged model from the Hub and load it (requires network)."""
    from huggingface_hub import snapshot_download

    local = snapshot_download(repo_id=repo_id, token=token)
    return load_model_from_package(local, device=device)


def load_agent_from_hub(repo_id: str, env, token: Optional[str] = None, *,
                        device: DeviceLike = "cuda"):
    """Download a packaged SAC agent from the Hub and reconstruct it."""
    from huggingface_hub import snapshot_download

    from mbrl_tpu_torch.planning import load_agent

    local = snapshot_download(repo_id=repo_id, token=token)
    return load_agent(local, env, device=device)

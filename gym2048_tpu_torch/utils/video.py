"""Episode video recording (counterpart of ``gym2048_tpu/utils/video.py``,
over the port's numpy adapter; ``PIL`` is imported only when recording).

Replaces the reference's RecordVideo callback (ppo_train.py:89-115): plays
one greedy episode on the host adapter and writes an animated GIF of the
rendered boards (GIF via PIL — no ffmpeg dependency).
"""

from __future__ import annotations

from pathlib import Path


def record_episode_gif(
    choose_action_fn,
    path: str | Path,
    seed: int | None = None,
    max_steps: int = 2000,
    fps: int = 4,
    frame_stride: int = 1,
) -> dict:
    """Play one episode with ``choose_action_fn(observation) -> int`` and
    save the board frames as a GIF. Returns episode stats.

    ``frame_stride`` keeps every N-th frame (plus the final one) — strong
    agents play many thousands of moves and a full-rate GIF would be
    enormous.
    """
    from PIL import Image

    from gym2048_tpu_torch.env import adapter

    env = adapter.Game2048Env()
    obs, _ = env.reset(seed=seed)
    frames = [Image.fromarray(env.render(mode="rgb_array"))]
    total_reward, steps = 0.0, 0
    info = {"highest": env.highest()}
    while steps < max_steps:
        action = choose_action_fn(obs)
        obs, reward, terminated, truncated, info = env.step(int(action))
        total_reward += reward
        steps += 1
        if steps % frame_stride == 0 or terminated or truncated:
            frames.append(Image.fromarray(env.render(mode="rgb_array")))
        if terminated or truncated:
            break
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    frames[0].save(
        path,
        save_all=True,
        append_images=frames[1:],
        duration=int(1000 / fps),
        loop=0,
    )
    return {
        "steps": steps,
        "total_reward": total_reward,
        "highest": int(info["highest"]),
        "frames": len(frames),
        "path": str(path),
    }

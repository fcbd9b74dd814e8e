"""Headless trajectory renderer: a rollout's states drawn with Pillow and
written as a GIF (counterpart of :mod:`dcc_tpu.render.gif`).

:func:`rollout_states` rolls envs on the device through ``MAPPO.act`` (the
trunk kernel K2 in bf16) and returns the renderable state as numpy arrays.
:func:`draw_frame` is the JAX package's drawing, call for call: agent bodies
with translucent r_cover / r_comm discs, PoIs gray -> green by energy,
comm links between agents within 2 r_comm, the +-bb boundary square, camera
range +-2, 700 x 700 px. :func:`render_gif` tiles the envs of a frame into
one near-square grid and writes the GIF with Pillow's ``save_all``, through
an exact palette of each frame's colors, so the file decodes to the frames.
A failure to write raises.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
from PIL import Image, ImageDraw

from ..envs import EnvConfig, get_scenario

FRAME_MS = 100  # a GIF frame's duration


@torch.no_grad()
def rollout_states(algo, ts, generator: Optional[torch.Generator] = None,
                   deterministic: bool = False, n_envs: int = 1) -> dict:
    """Roll ``n_envs`` envs of the algorithm's scenario for its horizon
    (MAPPO's ``episode_length``, MADDPG's ``steps_per_iter``) from a fresh
    reset, without auto-reset, as the JAX package's render rollout. Returns
    numpy arrays pos (T+1, N, 2), poi_pos (T+1, M, 2), energy (T+1, M),
    poi_done (T+1, M), reward (T,) and coverage (T,); with ``n_envs`` > 1
    each gains an env axis after time ((T+1, E, N, 2), ...). Actions and a
    random reset draw from ``generator`` (default ``ts.generator``)."""
    env_cfg = algo.env_cfg
    T = getattr(algo.cfg, "episode_length", None) or algo.cfg.steps_per_iter
    sc = get_scenario(algo.scenario)
    reset, step, observation = sc["reset"], sc["step"], sc["observation"]
    gen = ts.generator if generator is None else generator
    state = reset(env_cfg, n_envs, device=algo.device,
                  generator=gen if env_cfg.random_reset else None)
    obs = observation(env_cfg, state)
    logs = [(state.pos, state.poi_pos, state.energy, state.poi_done)]
    rew, cover = [], []
    for _ in range(T):
        action, _ = algo.act(ts, obs.reshape(n_envs * env_cfg.n_agents, -1), deterministic,
                             gen)
        state, out = step(env_cfg, state, action.reshape(n_envs, env_cfg.n_agents, -1))
        obs = out.obs
        logs.append((state.pos, state.poi_pos, state.energy, state.poi_done))
        rew.append(out.reward)
        cover.append(out.coverage_rate)
    # one copy to the host at the end, none per step
    sq = (lambda x: x[:, 0]) if n_envs == 1 else (lambda x: x)
    fields = [sq(torch.stack(f).cpu().numpy()) for f in zip(*logs)]
    return {
        "pos": fields[0],
        "poi_pos": fields[1],
        "energy": fields[2],
        "poi_done": fields[3],
        "reward": sq(torch.stack(rew).cpu().numpy()),
        "coverage": sq(torch.stack(cover).cpu().numpy()),
    }


def tile_images(imgs: Sequence[np.ndarray]) -> np.ndarray:
    """Tile N HxWxC frames into one near-square image, zero padded."""
    imgs = np.asarray(imgs)
    n, h, w, c = imgs.shape
    cols = int(np.ceil(np.sqrt(n)))
    rows = int(np.ceil(n / cols))
    pad = rows * cols - n
    if pad:
        imgs = np.concatenate([imgs, np.zeros((pad, h, w, c), imgs.dtype)], 0)
    grid = imgs.reshape(rows, cols, h, w, c).transpose(0, 2, 1, 3, 4)
    return grid.reshape(rows * h, cols * w, c)


def _w2p(xy: np.ndarray, size: int, cam_range: float = 2.0) -> np.ndarray:
    """World [-cam_range, cam_range] -> pixel coords (y flipped)."""
    p = (xy / cam_range + 1.0) * 0.5 * size
    p[..., 1] = size - p[..., 1]
    return p


def draw_frame(
    env_cfg: EnvConfig,
    pos: np.ndarray,
    poi_pos: np.ndarray,
    energy: np.ndarray,
    poi_done: np.ndarray,
    size: int = 700,
) -> np.ndarray:
    """Render one frame to an (size, size, 3) uint8 array."""
    scale = size / 4.0  # world units -> px (cam_range 2 => 4 world units wide)
    img = Image.new("RGBA", (size, size), (255, 255, 255, 255))
    draw = ImageDraw.Draw(img, "RGBA")

    def circle(center, radius_world, rgba):
        c = _w2p(np.array(center, dtype=float), size)
        r = radius_world * scale
        draw.ellipse([c[0] - r, c[1] - r, c[0] + r, c[1] + r], fill=rgba)

    # a scenario config without coverage's fields takes the JAX package's
    # fallbacks (spread: occupy_radius as the cover disc, no comm)
    r_comm = getattr(env_cfg, "r_comm", 0.0)
    r_cover = getattr(env_cfg, "r_cover", getattr(env_cfg, "occupy_radius", 0.1))
    m_energy = getattr(env_cfg, "m_energy", 1.0)
    ent_size = getattr(env_cfg, "size", 0.02)

    # boundary square (corners at +-bb)
    bb = getattr(env_cfg, "bb", getattr(env_cfg, "soft_bound", 1.0))
    corners = _w2p(np.array([[bb, bb], [bb, -bb], [-bb, -bb], [-bb, bb], [bb, bb]]), size)
    draw.line([tuple(p) for p in corners], fill=(0, 0, 0, 255), width=2)

    # comm / cover discs (alpha 0.15 over white)
    for p in pos:
        if r_comm > 0:
            circle(p, r_comm, (13, 89, 13, 38))
        circle(p, r_cover, (13, 64, 13, 38))

    # comm links between agents within 2 r_comm
    n = len(pos)
    for a in range(n):
        for b in range(a + 1, n):
            if r_comm > 0 and np.linalg.norm(pos[a] - pos[b]) < 2.0 * r_comm:
                pa, pb = _w2p(pos[a].astype(float), size), _w2p(pos[b].astype(float), size)
                draw.line([tuple(pa), tuple(pb)], fill=(0, 0, 0, 180), width=1)

    # PoIs: color (0.25, 0.25 + energy / m_energy * 0.75, 0.25), clamped
    for p, e in zip(poi_pos, energy):
        g = min(0.25 + float(e) / m_energy * 0.75, 1.0)
        circle(p, ent_size, (64, int(255 * g), 64, 255))

    # agent bodies (color 0.05, 0.15, 0.05, alpha 0.5)
    for p in pos:
        circle(p, ent_size, (13, 38, 13, 128))

    return np.asarray(img.convert("RGB"))


def _palette_image(frame: np.ndarray) -> Image.Image:
    """The frame as a palette image whose palette holds its colors exactly
    (at most 256, as a GIF frame)."""
    f = frame.astype(np.uint32)
    codes, index = np.unique((f[..., 0] << 16) | (f[..., 1] << 8) | f[..., 2],
                             return_inverse=True)
    if len(codes) > 256:
        raise ValueError(f"a frame of {len(codes)} colors does not fit a GIF palette")
    img = Image.fromarray(index.reshape(frame.shape[:2]).astype(np.uint8), mode="P")
    rgb = np.stack([codes >> 16, (codes >> 8) & 255, codes & 255], axis=-1)
    img.putpalette(rgb.astype(np.uint8).reshape(-1).tolist())
    return img


def render_gif(
    env_cfg: EnvConfig,
    states: dict,
    path: Optional[str],
    size: int = 700,
) -> List[np.ndarray]:
    """Draw one frame per logged step of rollout states, tiling the envs of
    multi-env logs (pos ndim 4) into one grid, and write them to ``path`` as
    a looping GIF of ``FRAME_MS`` a frame unless ``path`` is None. Returns
    the frames."""

    def frame(t, e=None):
        pick = (lambda k: states[k][t]) if e is None else (lambda k: states[k][t, e])
        return draw_frame(env_cfg, pick("pos"), pick("poi_pos"), pick("energy"),
                          pick("poi_done"), size=size)

    steps = range(len(states["pos"]))
    if np.asarray(states["pos"]).ndim == 4:
        n_envs = states["pos"].shape[1]
        frames = [tile_images(np.stack([frame(t, e) for e in range(n_envs)])) for t in steps]
    else:
        frames = [frame(t) for t in steps]
    if path is not None:
        images = [_palette_image(f) for f in frames]
        images[0].save(path, format="GIF", save_all=True, append_images=images[1:],
                       duration=FRAME_MS, loop=0)
    return frames

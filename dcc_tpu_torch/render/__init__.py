from .gif import draw_frame, render_gif, rollout_states, tile_images
from .live import LiveViewer

__all__ = ["LiveViewer", "draw_frame", "render_gif", "rollout_states", "tile_images"]

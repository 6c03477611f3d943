"""Board rendering: ANSI text and RGB frames (a copy of
``gym2048_tpu/utils/render.py``; ``PIL`` is imported only by the RGB renderer).

Reproduces the reference renderer (game2048_env.py:113-163): a 280x280 RGB
frame with the same tile colour map, grey background and centred white tile
labels. Two robustness deviations from the reference (documented, both of
which *crash* there): tiles above 4096 fall back to a dark colour instead of
KeyError, and when ``Arial.ttf`` is unavailable the PIL default font is used.
"""

from __future__ import annotations

import numpy as np

_TILE_COLOURS = {
    2: (255, 0, 0), 4: (224, 32, 0), 8: (192, 64, 0), 16: (160, 96, 0),
    32: (128, 128, 0), 64: (96, 160, 0), 128: (64, 192, 0),
    256: (32, 224, 0), 512: (0, 255, 0), 1024: (0, 224, 32),
    2048: (0, 192, 64), 4096: (0, 160, 96),
}
_FALLBACK_COLOUR = (0, 128, 128)

_font_cache = {}


def _get_font(size: int = 30):
    if size not in _font_cache:
        from PIL import ImageFont

        try:
            _font_cache[size] = ImageFont.truetype("Arial.ttf", size)
        except OSError:
            try:
                _font_cache[size] = ImageFont.truetype(
                    "DejaVuSans-Bold.ttf", size
                )
            except OSError:
                _font_cache[size] = ImageFont.load_default()
    return _font_cache[size]


def render_rgb(board_values: np.ndarray, grid_size: int = 70) -> np.ndarray:
    """Render a (4, 4) tile-value board to an RGB array (4*grid px square)."""
    from PIL import Image, ImageDraw

    grey = (128, 128, 128)
    white = (255, 255, 255)
    board_values = np.asarray(board_values)

    img = Image.new("RGB", (grid_size * 4, grid_size * 4))
    draw = ImageDraw.Draw(img)
    draw.rectangle([0, 0, 4 * grid_size, 4 * grid_size], grey)
    fnt = _get_font(30)

    for y in range(4):
        for x in range(4):
            o = int(board_values[y, x])
            if not o:
                continue
            colour = _TILE_COLOURS.get(o, _FALLBACK_COLOUR)
            draw.rectangle(
                [x * grid_size, y * grid_size,
                 (x + 1) * grid_size, (y + 1) * grid_size],
                colour,
            )
            text = str(o)
            bbox = draw.textbbox((0, 0), text, font=fnt)
            tw, th = bbox[2] - bbox[0], bbox[3] - bbox[1]
            draw.text(
                (x * grid_size + (grid_size - tw) // 2,
                 y * grid_size + (grid_size - th) // 2),
                text, font=fnt, fill=white,
            )
    return np.asarray(img)


def render_ansi(board_values: np.ndarray, score: float = 0.0) -> str:
    """Plain-text board like the reference 'human'/'ansi' modes."""
    board_values = np.asarray(board_values)
    highest = int(board_values.max()) if board_values.size else 0
    return (
        f"Score: {score}\nHighest: {highest}\n"
        f"{board_values.reshape(4, 4)}\n"
    )

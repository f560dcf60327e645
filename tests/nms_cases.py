"""Greedy-NMS inputs shared by the CPU parity tests, the card tests and
``chip_smoke.py``: numpy only, every draw from a seed.

Each case returns (boxes (F, K, 4) f32, valid (F, K) bool), boxes in
score order.
"""

import numpy as np

THRESHOLD = 0.3


def random_boxes(rng, n, span=200.0):
    xy = rng.uniform(0, span, (n, 2))
    wh = rng.uniform(5, 80, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def chain_boxes(n, step=10.0):
    """Boxes 50 px wide sliding by ``step`` px. At 10 px each overlaps its
    neighbour at IoU 0.6 and the one after next at 0.33, so greedy keeps
    every third box; at 20 px its neighbour at 0.43 and the one after next
    at 0.11, so every box suppresses the next and greedy keeps every second
    one. Either way the suppression chain runs the whole length."""
    x = np.arange(n, dtype=np.float32) * np.float32(step)
    return np.stack([x, np.zeros(n), x + 49.0, np.full(n, 49.0)],
                    1).astype(np.float32)


def _iou32(a, b):
    """The twin's f32 IoU of two boxes, in its operation order."""
    f = np.float32
    area = [(f(x2) - f(x1) + f(1)) * (f(y2) - f(y1) + f(1))
            for x1, y1, x2, y2 in (a, b)]
    w = max(f(0), min(f(a[2]), f(b[2])) - max(f(a[0]), f(b[0])) + f(1))
    h = max(f(0), min(f(a[3]), f(b[3])) - max(f(a[1]), f(b[1])) + f(1))
    inter = w * h
    return inter / (area[0] + area[1] - inter)


def tie_pairs():
    """Pairs (kept box, second box) whose f32 IoU is exactly the f32
    threshold (3 / 10 rounds as 0.3 does), one ulp below it and one ulp
    above it: the second box's y2 is walked ulp by ulp from a 3/10 pair."""
    t = np.float32(THRESHOLD)
    a = np.array([0, 0, 1, 2], np.float32)          # area 6
    b = np.array([0, 0, 1, 9], np.float32)          # area 20, inter 6
    assert _iou32(a, b) == t
    out = {"exact": (a, b.copy())}
    for name, toward in (("below", np.float32(np.inf)),
                         ("above", np.float32(-np.inf))):
        c = b.copy()
        while _iou32(a, c) == t:
            c[3] = np.nextafter(c[3], toward)
        out[name] = (a, c)
    return out


def nms_case(name, k=2048, seed=0):
    """The named case at K = ``k`` candidates (cases that fix their own
    size ignore it):

    - ``random``: 3 frames of spread boxes;
    - ``crowd``: 2 frames of heavy overlap (a crowded frame), 10% padding;
    - ``padding``: 64 real boxes, then their duplicates as padding;
    - ``duplicates``: every box three times in a row;
    - ``chain``: the suppression chain over all ``k`` boxes;
    - ``ties``: the three tie pairs, repeated at integer offsets, with
      random boxes far from them;
    - ``frames``: 4 frames with 0, 1, ``k`` / 2 and ``k`` valid boxes;
    - ``ragged``: K = 100, not a multiple of 64;
    - ``tile_edges``: K = 256, 64-box tiles' edges: frames whose last valid
      box is 63, 64, 65, 127 and 128; a frame with a 10 px chain over boxes
      40-100 (across the tile edge at 64); a frame whose tile 1 (boxes
      64-127) is a 20 px chain, every box suppressing the next;
    - ``holes``: K = 256, valid masks that are not a prefix: a whole tile
      invalid (boxes 64-127 in one frame, 0-63 in the other) among random
      gaps;
    - ``wide``: K = 2,112, past 2,048, so tile 0's row holds 33 words (two
      of N1's 32-word chunks) in the frame whose boxes are all valid; the
      other frame's last valid box is below 2,048.
    """
    rng = np.random.default_rng(seed)
    if name == "random":
        boxes = np.stack([random_boxes(rng, k) for _ in range(3)])
        valid = np.ones((3, k), bool)
    elif name == "crowd":
        boxes = np.stack([random_boxes(rng, k, span=60.0 * (k / 300) ** 0.5)
                          for _ in range(2)])
        valid = rng.uniform(size=(2, k)) < 0.9
    elif name == "padding":
        boxes = np.concatenate([random_boxes(rng, 64)] * 2)[None]
        valid = np.arange(128)[None] < 64
    elif name == "duplicates":
        boxes = np.repeat(random_boxes(rng, -(-k // 3)), 3, axis=0)[None, :k]
        valid = np.ones((1, k), bool)
    elif name == "chain":
        boxes = chain_boxes(k)[None]
        valid = np.ones((1, k), bool)
    elif name == "ties":
        pairs = [p for p in tie_pairs().values() for _ in range(4)]
        tied = []
        for i, (a, b) in enumerate(pairs):
            off = np.array([40 * i, 0, 40 * i, 0], np.float32)
            tied += [a + off, b + off]
        rest = random_boxes(rng, 40) + np.float32(2000)
        boxes = np.concatenate([np.stack(tied), rest])[None]
        valid = np.ones(boxes.shape[:2], bool)
    elif name == "frames":
        boxes = np.stack([random_boxes(rng, k, span=120.0)
                          for _ in range(4)])
        counts = np.array([0, 1, k // 2, k])
        valid = np.arange(k)[None] < counts[:, None]
    elif name == "ragged":
        boxes = np.stack([random_boxes(rng, 100, span=80.0)
                          for _ in range(2)])
        valid = rng.uniform(size=(2, 100)) < 0.8
    elif name == "tile_edges":
        boxes = np.stack([random_boxes(rng, 256, span=120.0)
                          for _ in range(7)])
        far = np.float32(5000)
        boxes[5, 40:101] = chain_boxes(61) + far
        boxes[6, 64:128] = chain_boxes(64, step=20.0) + far
        last = np.array([63, 64, 65, 127, 128, 255, 255])
        valid = np.arange(256)[None] <= last[:, None]
    elif name == "holes":
        boxes = np.stack([random_boxes(rng, 256, span=120.0)
                          for _ in range(2)])
        valid = rng.uniform(size=(2, 256)) < 0.85
        valid[0, 64:128] = False
        valid[1, 0:64] = False
    elif name == "wide":
        boxes = np.stack([random_boxes(rng, 2112, span=160.0)
                          for _ in range(2)])
        valid = np.ones((2, 2112), bool)
        valid[1] = np.arange(2112) < 2000
        valid[1] &= rng.uniform(size=2112) < 0.9
    else:
        raise ValueError(name)
    return boxes.astype(np.float32), valid


CASES = ("random", "crowd", "padding", "duplicates", "chain", "ties",
         "frames", "ragged", "tile_edges", "holes", "wide")

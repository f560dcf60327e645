"""The optional image libraries, imported where an image is read, written
or drawn.

OpenCV (``cv2``) and matplotlib read, write and draw the apps' images. The
card's machine may have neither, and nothing on the compute path needs
them, so no module imports them at import time: a function that touches
an image file calls :func:`import_cv2` or :func:`import_pyplot`, which
raise an error naming the missing library and what needed it.
"""

from __future__ import annotations


def import_cv2(what: str):
    """``cv2``, or an ImportError saying that ``what`` needs OpenCV."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            f"{what} reads or writes images with OpenCV (cv2), which is not "
            "installed; install opencv-python") from e
    return cv2


def import_pyplot(what: str):
    """``matplotlib.pyplot`` on the non-interactive Agg backend, or an
    ImportError saying that ``what`` needs matplotlib."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError as e:
        raise ImportError(
            f"{what} draws with matplotlib, which is not installed; "
            "install matplotlib") from e
    return plt

"""Host-side image IO (the port's own copy of
``embeddingnet_tpu/data/images.py``).

Same decode contract as the reference: cv2 ``imread`` (**BGR** channel
order) + cv2 bilinear ``resize`` to ``[H, W, 3]`` = ``input_shape[:2]``.
Images stay uint8 on the host; ``/255`` happens on the device. ``cv2`` is
imported inside :func:`get_image`, so that the module imports where OpenCV
is not installed.
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence

import numpy as np

log = logging.getLogger(__name__)


def get_image(img_path: str,
              input_shape: Optional[Sequence[int]] = None
              ) -> Optional[np.ndarray]:
    """BGR uint8 image, resized to ``(input_shape[0], input_shape[1])`` =
    (H, W) (cv2's ``dsize`` is (W, H)). A missing or corrupt file logs and
    returns None."""
    import cv2
    img = cv2.imread(img_path)
    if img is None:
        log.warning("image does not exist: %s", img_path)
        return None
    if input_shape:
        img = cv2.resize(img, (input_shape[1], input_shape[0]))
    return img


def get_images(img_paths: Sequence[str],
               input_shape: Optional[Sequence[int]] = None) -> np.ndarray:
    """Stacked uint8 batch; missing files are dropped."""
    imgs = [get_image(p, input_shape) for p in img_paths]
    imgs = [im for im in imgs if im is not None]
    return np.array(imgs)

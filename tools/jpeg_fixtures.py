"""Write the JPEG fixtures that chip_smoke.py embeds for the kinds PIL
cannot write (arithmetic-coded, lossless, YCCK) and the 4-component kinds,
with tests/test_torch_images.py's writers, and print them as entries of
chip_smoke.EMBEDDED_JPEGS: the base64 of the file, the SHA-256 of PIL's
Image.open(...).convert("RGB") pixels, and the size.  chip_smoke.py needs
no PIL: it checks its decodes against these hashes.

    python3 tools/jpeg_fixtures.py > /tmp/entries.py
"""

from __future__ import annotations

import base64
import hashlib
import io
import sys
from pathlib import Path

import numpy as np
from PIL import Image

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from tests.test_torch_images import (  # noqa: E402
    arithmetic_jpeg,
    huffman_coefficients,
    lossless_jpeg,
    photo,
    pil_cmyk_jpeg,
    pil_jpeg,
    progressive_script,
    ycck_jpeg,
    _without_adobe,
)

H, W = 32, 48


def fixtures() -> dict[str, tuple[str, bytes]]:
    """name: (what it is, the file)."""
    base = pil_jpeg(photo(H, W, 50), quality=85, subsampling="4:2:0")
    coef = huffman_coefficients(base)
    return {
        "arithmetic": ("SOF9 4:2:0, DAC conditioning, a restart marker every 4 MCUs",
                       arithmetic_jpeg(coef, restart=4, dac=(1, 3, 2))),
        "arithmetic_progressive": ("SOF10 4:2:0, spectral selection and successive "
                                   "approximation", arithmetic_jpeg(
                                       coef, script=progressive_script(3))),
        "lossless": ("SOF3 RGB, predictor 4, restart every 8 rows",
                     lossless_jpeg(photo(H, W, 51), 4, restart_rows=8)),
        "cmyk": ("Adobe CMYK (transform 0) written by PIL, quality 85",
                 pil_cmyk_jpeg(H, W, 52, quality=85)),
        "ycck": ("Adobe YCCK (transform 2), 4:2:0 with full-size K",
                 ycck_jpeg(((2, 2), (1, 1), (1, 1), (2, 2)), h=H, w=W)),
        "cmyk_no_adobe": ("4 components without an Adobe marker (CMYK)",
                          _without_adobe(pil_cmyk_jpeg(H, W, 53, quality=85))),
    }


def main() -> int:
    for name, (what, data) in fixtures().items():
        img = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        sha = hashlib.sha256(img.tobytes()).hexdigest()
        b64 = base64.b64encode(data).decode()
        lines = [b64[i : i + 92] for i in range(0, len(b64), 92)]
        print(f"    # {img.shape[1]}x{img.shape[0]} {what}")
        print(f'    "{name}": ((')
        for line in lines:
            print(f'    "{line}"')
        print(f'    ), "{sha}", {img.shape[:2]}),')
    return 0


if __name__ == "__main__":
    sys.exit(main())

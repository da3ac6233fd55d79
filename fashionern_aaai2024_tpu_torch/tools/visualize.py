"""HTML retrieval visualizer of the port.

JAX counterpart: `fashionern_aaai2024_tpu/tools/visualize.py` (itself the
port of the reference `utils/visualize.py:7-88`), kept as it is: the
same page for the same inputs, byte for byte. Stdlib only, and PIL
inside `_b64`, where an image is read.

Dumps a table per query: reference image + modifier text, then top-k
retrieved gallery images (base64-inlined so the file is standalone),
with the ground-truth hit highlighted.
"""

from __future__ import annotations

import base64
import html
import io
import os
from typing import Sequence

_PAGE = """<!doctype html><html><head><meta charset="utf-8">
<style>
 body {{ font-family: sans-serif; }}
 td {{ padding: 4px; text-align: center; vertical-align: top; }}
 img {{ max-width: 160px; max-height: 160px; }}
 .hit {{ outline: 4px solid #2a2; }}
 .caption {{ max-width: 200px; }}
</style></head><body><h2>{title}</h2><table border="1">{rows}</table></body></html>
"""


def _b64(path: str, thumb: int = 256) -> str:
    from PIL import Image

    with Image.open(path) as img:
        img = img.convert("RGB")
        img.thumbnail((thumb, thumb))
        buf = io.BytesIO()
        img.save(buf, format="JPEG", quality=85)
    return "data:image/jpeg;base64," + base64.b64encode(buf.getvalue()).decode()


def write_retrieval_html(
    out_path: str,
    queries: Sequence[dict],
    *,
    title: str = "Retrieval results",
    k: int = 10,
) -> str:
    """queries: dicts with keys
      ref_image (path), caption (str), results (list of image paths),
      optional target (path or name matched against results).
    """
    rows = []
    header = "<tr><th>reference</th><th>modifier</th>" + "".join(
        f"<th>top{i + 1}</th>" for i in range(k)
    ) + "</tr>"
    rows.append(header)
    for q in queries:
        cells = [f'<td><img src="{_b64(q["ref_image"])}"></td>',
                 f'<td class="caption">{html.escape(q["caption"])}</td>']
        target = q.get("target")
        for r in list(q["results"])[:k]:
            hit = target is not None and (
                r == target or os.path.splitext(os.path.basename(r))[0]
                == os.path.splitext(os.path.basename(str(target)))[0]
            )
            cls = ' class="hit"' if hit else ""
            cells.append(f'<td{cls}><img src="{_b64(r)}"></td>')
        rows.append("<tr>" + "".join(cells) + "</tr>")
    doc = _PAGE.format(title=html.escape(title), rows="\n".join(rows))
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        f.write(doc)
    return out_path

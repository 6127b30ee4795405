"""A static HTML gallery of a result directory.

Port of ``nerfsr_tpu/utils/html.py``: collects the images and GIFs that
``save_visuals`` wrote into one page (``index.html``)::

    from nerfsr_torch.utils.html import write_gallery
    write_gallery("./results/exp/test_30", title="exp test renders")
"""

from __future__ import annotations

import html
import os


def write_gallery(result_dir: str, title: str = "results",
                  out_name: str = "index.html", per_row: int = 4) -> str:
    exts = (".png", ".jpg", ".jpeg", ".gif")
    images = sorted(f for f in os.listdir(result_dir)
                    if f.lower().endswith(exts))
    rows = []
    for i in range(0, len(images), per_row):
        cells = "".join(
            f'<td><a href="{html.escape(f)}">'
            f'<img src="{html.escape(f)}" style="max-width:260px"></a>'
            f"<br><small>{html.escape(f)}</small></td>"
            for f in images[i:i + per_row])
        rows.append(f"<tr>{cells}</tr>")
    doc = (f"<!doctype html><html><head><meta charset='utf-8'>"
           f"<title>{html.escape(title)}</title></head><body>"
           f"<h2>{html.escape(title)}</h2>"
           f"<table>{''.join(rows)}</table></body></html>")
    path = os.path.join(result_dir, out_name)
    with open(path, "w") as f:
        f.write(doc)
    return path

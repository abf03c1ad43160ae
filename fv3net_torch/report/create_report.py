"""Self-contained HTML report writer (reference:
external/report/report/create_report.py — same item vocabulary, stdlib
templating instead of jinja).

Host copy of ``fv3net_tpu/report/create_report.py``.
"""
from __future__ import annotations

import base64
import datetime
import html
import io
import os
from typing import Mapping, Optional, Sequence


class ImagePlot:
    """An image item; accepts a filesystem path or a matplotlib figure
    (embedded as base64 so reports are single-file)."""

    def __init__(self, image, caption: str = ""):
        self.image = image
        self.caption = caption

    def render(self) -> str:
        if hasattr(self.image, "savefig"):
            src = fig_to_b64(self.image, dpi=110)
        else:
            src = str(self.image)
        cap = f"<figcaption>{html.escape(self.caption)}</figcaption>" if self.caption else ""
        return f'<figure><img src="{src}" style="max-width:100%">{cap}</figure>'


class Link:
    def __init__(self, tag: str, url: str):
        self.tag = tag
        self.url = url

    def render(self) -> str:
        return f'<a href="{html.escape(self.url)}">{html.escape(self.tag)}</a>'


class OrderedList:
    def __init__(self, *items):
        self.items = items

    def render(self) -> str:
        lis = "".join(
            f"<li>{i.render() if hasattr(i, 'render') else html.escape(str(i))}</li>"
            for i in self.items
        )
        return f"<ol>{lis}</ol>"


class RawHTML:
    def __init__(self, content: str):
        self.content = content

    def render(self) -> str:
        return self.content


HTML = RawHTML  # reference alias


def _render_item(item) -> str:
    if hasattr(item, "render"):
        return item.render()
    return f"<p>{html.escape(str(item))}</p>"


def _render_table(title: str, data: Mapping) -> str:
    rows = "".join(
        f"<tr><td>{html.escape(str(k))}</td><td>{html.escape(str(v))}</td></tr>"
        for k, v in data.items()
    )
    return (
        f"<h3>{html.escape(title)}</h3>"
        f'<table border="1" cellpadding="4" style="border-collapse:collapse">'
        f"{rows}</table>"
    )


def create_html(
    sections: Mapping[str, Sequence],
    title: str,
    metadata: Optional[Mapping] = None,
    metrics: Optional[Mapping] = None,
    collapse_metadata: bool = False,
) -> str:
    """Render sections of items into one HTML document
    (reference create_report.py:85 create_html)."""
    parts = [
        "<!DOCTYPE html><html><head><meta charset='utf-8'>",
        f"<title>{html.escape(title)}</title>",
        "<style>body{font-family:sans-serif;margin:2em;}"
        "h1{border-bottom:2px solid #333}</style></head><body>",
        f"<h1>{html.escape(title)}</h1>",
        f"<p>created {datetime.datetime.now().isoformat(timespec='seconds')}</p>",
    ]
    if metadata:
        parts.append(_render_table("Metadata", metadata))
    if metrics:
        parts.append(_render_table("Metrics", metrics))
    for section, items in sections.items():
        parts.append(f"<h2>{html.escape(section)}</h2>")
        parts.extend(_render_item(i) for i in items)
    parts.append("</body></html>")
    return "".join(parts)


def create_report(
    sections: Mapping[str, Sequence],
    title: str,
    output_dir: str,
    metadata: Optional[Mapping] = None,
    metrics: Optional[Mapping] = None,
) -> str:
    """Write index.html into output_dir; returns the path."""
    os.makedirs(output_dir, exist_ok=True)
    doc = create_html(sections, title, metadata=metadata, metrics=metrics)
    path = os.path.join(output_dir, "index.html")
    with open(path, "w") as f:
        f.write(doc)
    return path


def fig_to_b64(fig, format: str = "png", dpi=None) -> str:
    """Matplotlib figure -> base64 data URI (reference
    report/matplotlib.py:8-13)."""
    buf = io.BytesIO()
    fig.savefig(buf, format=format, bbox_inches="tight", dpi=dpi)
    buf.seek(0)
    return f"data:image/{format};base64," + base64.b64encode(buf.read()).decode()


def MatplotlibFigure(fig, width=None) -> "RawHTML":
    """Embed a matplotlib figure as an inline <img> (reference
    report/matplotlib.py:15-22)."""
    properties = {"src": fig_to_b64(fig)}
    if width:
        properties = {"width": width, **properties}
    attr = " ".join(f'{k}="{v}"' for k, v in properties.items())
    return RawHTML(f"<img {attr}/>")


def upload(html: str, path: str = None) -> str:
    """Publish a report by content hash (reference report/_io.py:19-27,
    which uploads to GCS; zero-egress here, so the store is a local
    directory — FV3NET_REPORT_DIR or ./reports)."""
    import hashlib
    import os

    root = path or os.environ.get("FV3NET_REPORT_DIR", "reports")
    os.makedirs(root, exist_ok=True)
    name = hashlib.md5(html.encode()).hexdigest() + ".html"
    out = os.path.join(root, name)
    with open(out, "w") as f:
        f.write(html)
    return out

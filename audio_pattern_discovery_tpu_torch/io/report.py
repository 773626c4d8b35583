"""Self-contained HTML report of a discovery run (SURVEY.md SS3 row 8, SS1.2).

One file, no external assets: cluster spectrogram PNGs are embedded as
base64 data URIs next to the member tables, so the report can be scp'd or
attached anywhere.  This is the human-inspection artifact the reference
pipeline's image output serves; the machine-readable contract stays in
clusters.json.

Copy of ``audio_pattern_discovery_tpu/io/report.py``; only the import paths differ.
"""

from __future__ import annotations

import base64
import html
from pathlib import Path


def write_html_report(out_dir: str | Path, manifest: dict) -> Path:
    """Render `manifest` (pipeline.DiscoveryResult.manifest()) to index.html.

    Embeds images/cluster*.png from `out_dir` when present."""
    out = Path(out_dir)
    img_dir = out / "images"

    def img_tag(cluster_id: int) -> str:
        p = img_dir / f"cluster{cluster_id:03d}.png"
        if not p.exists():
            return ""
        data = base64.b64encode(p.read_bytes()).decode()
        return (
            f'<img src="data:image/png;base64,{data}" '
            f'alt="cluster {cluster_id} spectrograms" style="max-width:100%">'
        )

    counters = manifest.get("counters", {})
    timings = counters.get("timings_s", {})
    rows = []
    for c in manifest["clusters"]:
        members = "".join(
            "<tr><td>{seg}</td><td>{f}</td><td>{s:.2f}-{e:.2f}s</td><td>{x}</td></tr>".format(
                seg=m["segment"],
                f=html.escape(Path(m["file"]).name),
                s=m["start_sample"] / m.get("sample_rate", 44_100),
                e=m["end_sample"] / m.get("sample_rate", 44_100),
                x="&#9733;" if m.get("is_exemplar") else "",
            )
            for m in c["members"]
        )
        rows.append(
            f"""
<section>
  <h2>Cluster {c['cluster_id']} &mdash; {len(c['members'])} members</h2>
  {img_tag(c['cluster_id'])}
  <table>
    <tr><th>segment</th><th>file</th><th>time</th><th>exemplar</th></tr>
    {members}
  </table>
</section>"""
        )

    timing_rows = "".join(
        f"<tr><td>{html.escape(k)}</td><td>{v:.3f}s</td></tr>"
        for k, v in timings.items()
    )
    ae = manifest.get("ae_losses") or []
    ae_note = (
        f"<p>Autoencoder: {len(ae)} epochs, final loss {ae[-1]:.5f}</p>" if ae else ""
    )
    doc = f"""<!doctype html>
<html><head><meta charset="utf-8"><title>audio pattern discovery report</title>
<style>
 body {{ font-family: system-ui, sans-serif; margin: 2rem auto; max-width: 70rem; }}
 table {{ border-collapse: collapse; margin: .5rem 0 1.5rem; }}
 td, th {{ border: 1px solid #ccc; padding: .2rem .6rem; font-size: .9rem; }}
 h2 {{ border-top: 2px solid #eee; padding-top: 1rem; }}
</style></head><body>
<h1>Discovered patterns</h1>
<p>{manifest['n_clips']} clips &middot; {manifest['n_segments']} segments &middot;
   {manifest['n_clusters']} clusters &middot;
   mean silhouette {manifest.get('silhouette_mean', 'n/a')}</p>
{ae_note}
<details><summary>Stage timings</summary><table>{timing_rows}</table></details>
{''.join(rows)}
</body></html>"""
    path = out / "index.html"
    path.write_text(doc)
    return path

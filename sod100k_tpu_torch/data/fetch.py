"""Offline-safe SOD dataset fetcher.

Port of ``sod100k_tpu/data/fetch.py``, code as it is. The reference trains
on DUTS-TR and evaluates on ECSSD/DUTS-TE (reference
CSNet_training/train.py:143, eval.py:19). One call downloads, unpacks and
validates a dataset into the tree that `cli.smoke --data-root` and the
YAML DATA.DIR convention expect (<root>/<name>/images/*.jpg +
<root>/<name>/GT/*.png).

Verification: the hosting sites publish no digests, so the fetcher pins
integrity trust-on-first-use: the sha256 of every downloaded archive is
recorded in <root>/CHECKSUMS.json on first fetch and verified on every
later one (pass `expected` to pin a known digest up front), plus a
structural gate: image/GT filename sets must match exactly and meet the
advertised count.

Offline, a network failure returns None instead of raising, so callers
fall back (cli.smoke synthesizes a dry-data tree).
"""

from __future__ import annotations

import hashlib
import json
import os
import zipfile

# Official distribution points. ECSSD is the reference's canonical test set
# (eval.py:19), DUTS-TR its training set (train.py:143); count = published
# dataset size. Each archive entry: {"url", optional "prefix"} — prefix
# selects members when one archive carries both kinds (DUTS-TR ships
# images + masks in a single zip; the file downloads once, extracts twice).
DATASETS = {
    "ECSSD": {
        "archives": {
            "images": {"url": "https://www.cse.cuhk.edu.hk/leojia/projects/"
                              "hsaliency/data/ECSSD/images.zip"},
            "GT": {"url": "https://www.cse.cuhk.edu.hk/leojia/projects/"
                          "hsaliency/data/ECSSD/ground_truth_mask.zip"},
        },
        "count": 1000,
    },
    "DUTS-TR": {
        "archives": {
            "images": {"url": "http://saliencydetection.net/duts/download/"
                              "DUTS-TR.zip", "prefix": "DUTS-TR-Image"},
            "GT": {"url": "http://saliencydetection.net/duts/download/"
                          "DUTS-TR.zip", "prefix": "DUTS-TR-Mask"},
        },
        "count": 10553,
    },
}


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while chunk := f.read(1 << 20):
            h.update(chunk)
    return h.hexdigest()


def _download(url: str, dest: str, timeout: float) -> bool:
    import urllib.error
    import urllib.request

    tmp = dest + ".part"
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r, \
                open(tmp, "wb") as f:
            while chunk := r.read(1 << 20):
                f.write(chunk)
        os.replace(tmp, dest)
        return True
    except (urllib.error.URLError, OSError, TimeoutError):
        if os.path.exists(tmp):
            os.remove(tmp)
        return False


def _extract_flat(archive: str, out_dir: str, exts: tuple[str, ...],
                  prefix: str | None = None) -> int:
    """Unpack every file with one of `exts` into out_dir, flattening any
    archive-internal directory layout (the ECSSD zips nest one folder).
    `prefix` selects a member subtree when one archive carries several."""
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    with zipfile.ZipFile(archive) as z:
        for info in z.infolist():
            base = os.path.basename(info.filename)
            if info.is_dir() or not base.lower().endswith(exts):
                continue
            if prefix and prefix not in os.path.dirname(info.filename):
                continue
            with z.open(info) as src, \
                    open(os.path.join(out_dir, base), "wb") as dst:
                dst.write(src.read())
            n += 1
    return n


def fetch_dataset(name: str, root: str, timeout: float = 120.0,
                  expected: dict[str, str] | None = None,
                  log=print) -> str | None:
    """Fetch dataset `name` into `root`/`name` (images/ + GT/), returning
    the dataset directory, or None when offline / on checksum mismatch.

    `expected`: optional {archive key: sha256} pins; otherwise digests are
    trust-on-first-use via `root`/CHECKSUMS.json. Already-complete trees
    are returned without touching the network."""
    if name not in DATASETS:
        raise ValueError(f"unknown dataset {name!r}; available: "
                         f"{', '.join(sorted(DATASETS))}")
    spec = DATASETS[name]
    ds_dir = os.path.join(root, name)
    img_dir, gt_dir = os.path.join(ds_dir, "images"), os.path.join(ds_dir, "GT")
    if _tree_ok(img_dir, gt_dir, spec["count"]):
        return ds_dir

    sums_path = os.path.join(root, "CHECKSUMS.json")
    sums = {}
    if os.path.isfile(sums_path):
        with open(sums_path) as f:
            sums = json.load(f)

    os.makedirs(ds_dir, exist_ok=True)
    for key, arc_spec in spec["archives"].items():
        url = arc_spec["url"]
        # cache by URL basename: a shared archive (DUTS-TR) downloads once
        arc = os.path.join(ds_dir, os.path.basename(url))
        if not os.path.isfile(arc):
            log(f"[fetch] {name}/{key}: downloading {url}")
            if not _download(url, arc, timeout):
                log(f"[fetch] {name}/{key}: network unreachable — skipping "
                    "(offline; use cli.smoke --dry-data)")
                return None
        digest = _sha256(arc)
        pin = (expected or {}).get(key) or sums.get(f"{name}/{key}")
        if pin is not None and digest != pin:
            os.remove(arc)
            log(f"[fetch] {name}/{key}: sha256 {digest[:12]} != pinned "
                f"{pin[:12]} — archive removed, not extracted")
            return None
        sums[f"{name}/{key}"] = digest
        out = img_dir if key == "images" else gt_dir
        exts = (".jpg", ".jpeg") if key == "images" else (".png",)
        try:
            n = _extract_flat(arc, out, exts, arc_spec.get("prefix"))
        except zipfile.BadZipFile:
            # e.g. an HTML error page served with HTTP 200: not a zip.
            # Remove it so a retry re-downloads instead of crashing on the
            # cached garbage forever, and keep the offline contract (None).
            os.remove(arc)
            log(f"[fetch] {name}/{key}: downloaded file is not a zip "
                "(HTML error page?) — removed, not extracted")
            return None
        log(f"[fetch] {name}/{key}: {n} files -> {out} "
            f"(sha256 {digest[:12]})")

    if not _tree_ok(img_dir, gt_dir, spec["count"]):
        # evict the cached archives AND the partial extraction: leaving them
        # would make every retry skip the download, re-extract the same bad
        # archive, and fail forever (and a later --data-root user could
        # mistake the partial tree for a dataset)
        import shutil
        shutil.rmtree(ds_dir, ignore_errors=True)
        log(f"[fetch] {name}: extracted tree failed validation — archive "
            "and partial tree removed so a retry re-downloads")
        return None
    # pin digests only AFTER structural validation: a truncated-but-valid
    # zip must not have its digest trust-on-first-use-pinned, or a later
    # correct download would be rejected against the bad pin forever
    with open(sums_path, "w") as f:
        json.dump(sums, f, indent=1, sort_keys=True)
    return ds_dir


def _tree_ok(img_dir: str, gt_dir: str, count: int) -> bool:
    """Structural gate: image/GT stems must match 1:1 at the full count."""
    try:
        stems_i = {os.path.splitext(e)[0] for e in os.listdir(img_dir)
                   if e.lower().endswith((".jpg", ".jpeg"))}
        stems_g = {os.path.splitext(e)[0] for e in os.listdir(gt_dir)
                   if e.lower().endswith(".png")}
    except OSError:
        return False
    return len(stems_i) >= count and stems_i == stems_g

"""Dataset acquisition from the config tree's ``source:`` blocks
(``nope_tpu/scripts/download_datasets.py``).

The reference ships download metadata in every data preset
(its ``configs/data/*.yaml`` — ``source.url``,
``source.cad_url``, ``source.http``, ``source.unzip_mode``) but no tool
that consumes it; users are left to fetch the BOP zips by hand.  This
CLI closes that gap::

    python -m nope_tpu_torch.scripts.download_datasets --config configs/train_all.yaml
    python -m nope_tpu_torch.scripts.download_datasets --config configs/data/tless_test.yaml --only tless_test

Per dataset: download ``url`` and ``cad_url`` archives into the
dataset's ``root_dir``, extract there per ``unzip_mode``, and skip
datasets already on disk (idempotent re-runs).  A state file inside
``root_dir`` records which sources finished, so an interrupted run
resumes with the missing archives instead of declaring a half-fetched
directory complete; directories populated by hand (no state file) are
left alone.  Sources with ``http: false`` are non-direct links
(gdrive/cloud shares) — they are printed for manual download instead of
fetched.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import urllib.request
from typing import Optional

from nope_tpu_torch.configs.config import DatasetConfig, load_config


def download_file(url: str, dest: str, chunk: int = 1 << 20) -> str:
    """Stream ``url`` to ``dest`` (skips when dest already exists)."""
    if os.path.exists(dest):
        logging.info("already downloaded: %s", dest)
        return dest
    os.makedirs(os.path.dirname(dest) or ".", exist_ok=True)
    tmp = dest + ".part"
    logging.info("downloading %s -> %s", url, dest)
    with urllib.request.urlopen(url) as resp, open(tmp, "wb") as out:
        while True:
            block = resp.read(chunk)
            if not block:
                break
            out.write(block)
    os.replace(tmp, dest)
    return dest


def extract_archive(archive: str, dest_dir: str, unzip_mode: str = "unzip") -> None:
    """Extract zip/tar archives.  The archive's own extension decides the
    format; ``unzip_mode`` (mirroring the reference's field) is only a
    hint for extension-less files — so a ``.tar.gz`` under the default
    ``unzip`` mode extracts as tar instead of failing with BadZipFile."""
    os.makedirs(dest_dir, exist_ok=True)
    is_tar = archive.endswith((".tar", ".tar.gz", ".tgz"))
    if archive.endswith(".zip") or (unzip_mode == "unzip" and not is_tar):
        import zipfile

        with zipfile.ZipFile(archive) as zf:
            for member in zf.namelist():
                # zipfile.extract sanitises absolute paths but not ".."
                # traversal on all versions; reject crafted archives
                if os.path.isabs(member) or ".." in member.split("/"):
                    raise ValueError(f"unsafe path in archive: {member!r}")
            zf.extractall(dest_dir)
    elif is_tar or unzip_mode == "tar":
        import tarfile

        with tarfile.open(archive) as tf:
            try:
                tf.extractall(dest_dir, filter="data")  # blocks traversal
            except TypeError:  # Python < 3.12 without the filter arg
                for member in tf.getmembers():
                    if os.path.isabs(member.name) or ".." in member.name.split("/"):
                        raise ValueError(f"unsafe path in archive: {member.name!r}")
                tf.extractall(dest_dir)
    else:
        logging.info("unzip_mode %r: leaving %s as-is", unzip_mode, archive)


STATE_FILE = ".nope_download_state.json"


def fetch_dataset(name: str, cfg: DatasetConfig, keep_archives: bool = False) -> bool:
    """Fetch + extract one dataset's archives into its root_dir.
    Returns True when the dataset is ready (present or fetched).

    A state file in root_dir lists the sources that finished; it exists
    only while a fetch is incomplete, so an interrupted run resumes the
    missing sources while hand-populated directories (no state file)
    are never touched.
    """
    source = dict(cfg.source or {})
    if not source:
        logging.info("%s: no source block; skipping", name)
        return os.path.isdir(cfg.root_dir)
    root = cfg.root_dir.rstrip("/")
    state_path = os.path.join(root, STATE_FILE)
    resuming = os.path.exists(state_path)
    if os.path.isdir(root) and os.listdir(root) and not resuming:
        logging.info("%s: %s already populated; skipping", name, root)
        return True
    if not source.get("http", True):
        logging.warning(
            "%s: source is not a direct link; download manually:\n  data: %s\n  cad:  %s",
            name, source.get("url"), source.get("cad_url"),
        )
        return False
    os.makedirs(root, exist_ok=True)
    done = []
    if resuming:
        with open(state_path) as f:
            done = json.load(f).get("done", [])
        logging.info("%s: resuming (done so far: %s)", name, done or "none")
    mode = source.get("unzip_mode", "unzip") or "unzip"
    with open(state_path, "w") as f:
        json.dump({"done": done}, f)
    for key in ("url", "cad_url"):
        url = source.get(key)
        if not url or key in done:
            continue
        fname = os.path.basename(url.split("?")[0]) or f"{name}_{key}.zip"
        archive = os.path.join(root, fname)
        download_file(url, archive)
        extract_archive(archive, root, mode)
        if not keep_archives:
            os.remove(archive)
        done.append(key)
        with open(state_path, "w") as f:
            json.dump({"done": done}, f)
    os.remove(state_path)  # complete: future runs take the skip path
    processing = source.get("processing")
    if processing:
        logging.info("%s: post-processing hint %r (see reference docs)", name, processing)
    return True


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", required=True, help="experiment or data preset yaml")
    parser.add_argument("--only", nargs="*", default=None,
                        help="dataset names to fetch (default: all with sources)")
    parser.add_argument("--keep-archives", action="store_true")
    parser.add_argument("overrides", nargs="*", default=[])
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    cfg = load_config(args.config, args.overrides)
    if args.only:
        unknown = sorted(set(args.only) - set(cfg.data.datasets))
        if unknown:
            parser.error(
                f"--only names {unknown} match no dataset; "
                f"config defines {sorted(cfg.data.datasets)}"
            )
    failed = []
    for name, ds in cfg.data.datasets.items():
        if args.only and name not in args.only:
            continue
        if not ds.source and args.only is None:
            continue
        try:
            ok = fetch_dataset(name, ds, keep_archives=args.keep_archives)
        except Exception:
            logging.exception("%s: fetch failed; continuing with the rest", name)
            ok = False
        if not ok:
            failed.append(name)
    if failed:
        logging.warning("datasets needing manual download or retry: %s", failed)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())

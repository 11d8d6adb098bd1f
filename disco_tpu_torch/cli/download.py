"""Corpus download CLI — the port's ``disco-download``, installed as
``disco-torch-download`` (counterpart of ``disco_tpu/cli/download.py``).

Mirrors reference ``pre_generation/download_freesound_queries.py:81-108``
(--token/--config/--num_jobs + output dir) plus the csv cleaning entry of
``clean_audio_info.py`` and a ``--list-urls`` mode printing the LibriSpeech /
Zenodo sources of the published DISCO corpus for the host's own fetcher
(download_librispeech.sh / zenodo.sh as a URL list).  Host code only: it
takes no ``--device`` and never touches the card."""
from __future__ import annotations

import argparse
import glob
import os

from disco_tpu_torch.datagen.download import (
    LIBRISPEECH_URLS,
    ZENODO_DISCO_NOISE_URL,
    DownloadConfig,
    FreesoundInquirer,
    clean_info,
    download_freesound,
    get_missing,
    set_up_log,
)


def build_parser():
    """Build the ``disco-download`` argument parser."""
    p = argparse.ArgumentParser(description="Fetch DISCO corpus material (Freesound/LibriSpeech/Zenodo)")
    p.add_argument("--token", "-t", default=None, help="Freesound OAuth token")
    p.add_argument("--config", "-c", default=None, help="yaml download config")
    p.add_argument("--out", "-o", default="dataset/freesound/data/")
    p.add_argument("--num_jobs", "-j", type=int, default=1)
    p.add_argument("--clean", metavar="DIR", default=None,
                   help="reconcile csv info files under DIR instead of downloading")
    p.add_argument("--list-urls", action="store_true",
                   help="print LibriSpeech + Zenodo corpus URLs and exit")
    return p


def main(argv=None):
    """``disco-download`` console entry point."""
    args = build_parser().parse_args(argv)
    logger = set_up_log(level=1)

    if args.list_urls:
        for url in LIBRISPEECH_URLS + [ZENODO_DISCO_NOISE_URL]:
            print(url)
        return 0

    if args.clean:
        n = 0
        for csv_path in glob.iglob(os.path.join(args.clean, "**", "*.csv"), recursive=True):
            missing = get_missing(csv_path)
            if missing:
                logger.warning(f"{csv_path}: files with no info: {missing}")
            n += clean_info(csv_path)
        print(f"dropped {n} stale csv rows")
        return 0  # console-script return values become exit codes

    if args.token is None or args.config is None:
        raise SystemExit("--token and --config are required for Freesound downloads")
    cfg = DownloadConfig.from_yaml(args.config)
    inquirer = FreesoundInquirer.from_token(args.token)
    n = download_freesound(cfg, inquirer, args.out, num_jobs=args.num_jobs)
    print(f"downloaded {n} files")
    return 0


if __name__ == "__main__":
    main()

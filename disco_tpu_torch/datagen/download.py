"""Corpus acquisition — the pre_generation subsystem (the port's copy of
``disco_tpu/datagen/download.py``).

Capability parity with reference ``dataset_generation/pre_generation/``
(download_freesound_queries.py:44-338, clean_audio_info.py:19-115,
utils.py:5-35): typed download config, a Freesound inquirer with paginated
query search and 200-id batched id search, a per-minute rate limiter, serial/
multiprocess execution, csv bookkeeping with dedup, csv<->disk reconciliation
and the structured logging setup.

Host code: it names no torch and touches no device.  Network-free by
construction: the inquirer takes any *client* object exposing
``text_search(**kwargs)`` (the freesound-python API surface), so a fake
client drives every code path, and the real ``freesound.FreesoundClient``
plugs straight in (:meth:`FreesoundInquirer.from_token` imports it only
when called).  The LibriSpeech / Zenodo fetches are plain URL lists for the
host's own downloader (reference download_librispeech.sh /
download_noises_from_zenodo.sh).  The csv ledgers are written through the
port's :func:`~disco_tpu_torch.io.atomic.atomic_write`.
"""
from __future__ import annotations

import csv as _csv
import functools
import glob
import logging
import os
import sys
import time
from collections import namedtuple
from multiprocessing import Pool

import numpy as np
import yaml

from disco_tpu_torch.io.atomic import atomic_write

# The published corpus sources (download_librispeech.sh:1-21,
# download_noises_from_zenodo.sh:1-14).
LIBRISPEECH_URLS = [
    "https://www.openslr.org/resources/12/test-clean.tar.gz",
    "https://www.openslr.org/resources/12/train-clean-100.tar.gz",
    "https://www.openslr.org/resources/12/train-clean-360.tar.gz",
]
ZENODO_DISCO_NOISE_URL = "https://zenodo.org/record/4019030/files/noises.zip"


def set_up_log(logfile: str = "", level: int = 0) -> logging.Logger:
    """Root-logger setup (reference pre_generation/utils.py:5-35):
    level 0 = warnings, 1 = info, else debug; file or stderr."""
    formatter = logging.Formatter(
        "[%(levelname)s] %(asctime)s %(funcName)s: %(message)s", "%Y-%m-%d %H:%M:%S"
    )
    if logfile:
        os.makedirs(os.path.dirname(logfile) or ".", exist_ok=True)
        handler: logging.Handler = logging.FileHandler(logfile)
    else:
        handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(formatter)
    logger = logging.getLogger()
    logger.handlers = [handler]
    logger.setLevel(logging.WARNING if level == 0 else logging.INFO if level == 1 else logging.DEBUG)
    return logger


class DownloadConfig(namedtuple("DownloadConfig", "queries, id_file, fields_to_save, min_duration")):
    """Freesound download configuration (download_freesound_queries.py:111-154):
    category->queries mapping and/or an id csv, with string queries promoted
    to single-element lists."""

    def __new__(cls, queries=None, id_file=None, fields_to_save=(), min_duration=5.5):
        queries = dict(queries or {})
        if not queries and not id_file:
            raise ValueError('At least one of "queries" and "id_file" must be non-empty')
        for key, value in queries.items():
            if isinstance(value, str):
                queries[key] = [value]
        return super().__new__(cls, queries, id_file, tuple(fields_to_save), min_duration)

    @classmethod
    def from_yaml(cls, config_file):
        with open(config_file) as fh:
            return cls(**(yaml.safe_load(fh) or {}))


class FreesoundInquirer:
    """Paginated / id-batched search over a Freesound-API-like client
    (download_freesound_queries.py:157-217).

    Args:
      client: object with ``text_search(query=..., filter=..., sort=...,
        fields=..., page_size=..., page=...)`` returning result pages whose
        ``as_dict()`` has a ``"next"`` key (freesound-python semantics).
    """

    ID_BATCH = 200  # Freesound encodes the query in the URL (ref :209)
    PAGE_SIZE = 150  # API maximum (ref :191)

    def __init__(self, client):
        self.client = client

    @classmethod
    def from_token(cls, token, authentication_method="oauth"):
        """Production constructor over the real freesound-python client
        (imported here: the package is an optional dependency)."""
        import freesound  # pragma: no cover - an optional dependency

        client = freesound.FreesoundClient()
        client.set_token(token, auth_type=authentication_method)
        return cls(client)

    def _paginate(self, **search_kwargs):
        """Yield every page of one search.  The reference breaks on
        next==None BEFORE yielding (download_freesound_queries.py:194-197),
        silently dropping the final page of every query — the evident intent
        (all pages) is implemented here instead (SURVEY.md §7 policy)."""
        page = 1
        while True:
            results = self.client.text_search(page_size=self.PAGE_SIZE, page=page, **search_kwargs)
            yield results
            if results.as_dict()["next"] is None:
                return
            page += 1

    def queries_to_files(self, queries, fields_to_save, min_duration=5.5):
        """Yield result pages for every query until the API reports no next
        page (ref :174-198)."""
        for query in queries:
            yield from self._paginate(
                query=query,
                filter=f"duration:[{min_duration} TO *]",
                sort="score",
                fields=",".join(fields_to_save),
            )

    def ids_to_files(self, ids, fields_to_save, min_duration=5.5):
        """Yield result pages for explicit ids, 200 per request, each batch
        paginated (the reference's single unpaginated call, ref :200-217,
        would only ever see the API's default first page)."""
        ids = list(ids)
        for i in range(int(np.ceil(len(ids) / self.ID_BATCH))):
            batch = ids[i * self.ID_BATCH : (i + 1) * self.ID_BATCH]
            yield from self._paginate(
                query="",
                filter=f'duration:[{min_duration} TO *] id:({" OR ".join(batch)})',
                sort="score",
                fields=",".join(fields_to_save),
            )


def extract_category_ids(id_file):
    """category -> id list from the labelled csv (ref :219-232,
    ids_per_category.csv layout: index column + one column per category)."""
    with open(id_file, newline="") as fh:
        rows = list(_csv.reader(fh))
    header = rows[0][1:]  # skip index column
    out = {cat: [] for cat in header}
    for row in rows[1:]:
        vals = row[1:]
        if len(vals) < len(header) or any(v == "" for v in vals[: len(header)]):
            continue  # dropna semantics: only fully-labelled rows
        for cat, v in zip(header, vals):
            out[cat].append(v)
    return out


def serial_exec(func, iterable):
    """(ref :250-257)"""
    return [func(*val) for val in iterable]


def parallel_exec(func, iterable, num_proc):
    """multiprocessing starmap execution (ref :234-246).  The workers run
    host code only (``retrieve`` a file); run the downloader in a process
    that holds no CUDA context, since the pool forks it."""
    with Pool(processes=num_proc) as pool:
        return list(pool.starmap(func, iterable))


def update_csv(data: dict, file_path, sort_label: str = "", sep: str = ","):
    """Merge ``data`` (dict of equal-length lists) into the csv, dropping
    duplicate rows, optionally mergesort-stable-sorted (ref :260-283)."""
    header = list(data.keys())
    new_rows = [list(map(str, row)) for row in zip(*data.values())]
    rows = []
    if os.path.isfile(file_path):
        with open(file_path, newline="") as fh:
            old = list(_csv.reader(fh, delimiter=sep))
        if old:
            header = old[0]
            rows = old[1:]
    rows += new_rows
    seen, dedup = set(), []
    for row in rows:
        key = tuple(row)
        if key not in seen:
            seen.add(key)
            dedup.append(row)
    if sort_label and sort_label in header:
        col = header.index(sort_label)
        dedup.sort(key=lambda r: r[col])  # python sort IS mergesort-stable
    os.makedirs(os.path.dirname(file_path) or ".", exist_ok=True)
    # atomic: the CSV is the download ledger a resumed run trusts — a torn
    # rewrite would re-download (or worse, skip) half the corpus
    with atomic_write(file_path, "w", newline="") as fh:
        w = _csv.writer(fh, delimiter=sep)
        w.writerow(header)
        w.writerows(dedup)


def limit_exec(function=None, *, max_per_minute=50, sleep=time.sleep, clock=time.time):
    """Rate-limit decorator: after ``max_per_minute`` calls inside a minute,
    sleep out the remainder (ref :285-317).  ``sleep``/``clock`` injectable
    for tests."""

    def arg_wrapper(func):
        @functools.wraps(func)
        def limited(*args, **kwargs):
            if limited.num_exec == 0:
                limited.start = clock()
            res = func(*args, **kwargs)
            limited.num_exec += 1
            if limited.num_exec == max_per_minute:
                remaining = 60 - (clock() - limited.start)
                if remaining > 0:
                    sleep(remaining)
                limited.num_exec = 0
            return res

        limited.num_exec = 0
        return limited

    return arg_wrapper if function is None else arg_wrapper(function)


def _plain_download(file, filename, output_dir):
    """One download; ``file`` is a Freesound sound object exposing
    ``retrieve(dir, name=...)`` (ref :320-333).  Picklable for Pool workers;
    rate limiting happens in the dispatcher (see download_freesound)."""
    logger = logging.getLogger(__name__)
    logger.info(f"downloading: {filename}")
    try:
        file.retrieve(output_dir, name=filename)
    except Exception:
        logger.warning(f"Error while downloading {filename}")


#: Rate-limited single-process variant (the reference's decorated form,
#: ref :320-333) for direct use outside the batched dispatcher.
limited_download = limit_exec(_plain_download)


# ------------------------------------------------- csv <-> disk reconciliation
def get_missing(csv_path, label="id", sep="\t"):
    """Audio files on disk (same dir as the csv) whose id is absent from the
    csv (reference clean_audio_info.py:62-84)."""
    folder = os.path.dirname(csv_path)
    with open(csv_path, newline="") as fh:
        rows = list(_csv.reader(fh, delimiter=sep))
    if not rows:
        return []
    ids = {row[rows[0].index(label)] for row in rows[1:] if row}
    missing = []
    for f in sorted(glob.glob(os.path.join(folder, "*"))):
        base = os.path.basename(f)
        if base.endswith(".csv"):
            continue
        file_id = base.split("_")[0].split(".")[0]
        if file_id not in ids:
            missing.append(base)
    return missing


def clean_info(csv_path, label="id", sep="\t"):
    """Drop csv rows whose audio file no longer exists on disk and rewrite
    (reference clean_audio_info.py:87-115)."""
    folder = os.path.dirname(csv_path)
    on_disk = set()
    for f in glob.glob(os.path.join(folder, "*")):
        base = os.path.basename(f)
        if not base.endswith(".csv"):
            on_disk.add(base.split("_")[0].split(".")[0])
    with open(csv_path, newline="") as fh:
        rows = list(_csv.reader(fh, delimiter=sep))
    if not rows:
        return 0
    header, body = rows[0], rows[1:]
    col = header.index(label)
    kept = [row for row in body if row and row[col] in on_disk]
    with atomic_write(csv_path, "w", newline="") as fh:
        w = _csv.writer(fh, delimiter=sep)
        w.writerow(header)
        w.writerows(kept)
    return len(body) - len(kept)


def download_freesound(
    config: DownloadConfig,
    inquirer: FreesoundInquirer,
    out_root,
    num_jobs: int = 1,
    max_per_minute: int = 50,
    sleep=time.sleep,
    clock=time.time,
):
    """The downloader main (ref :44-78): for each category, query (or id-list)
    search -> rate-limited downloads -> per-category csv of saved fields.

    Rate limiting is enforced in the DISPATCHING process (batches of
    ``max_per_minute`` per minute): with a worker pool, per-worker limiter
    state would multiply the effective request rate by ``num_jobs`` past the
    API quota (a latent flaw of the reference's in-worker decorator)."""
    logger = logging.getLogger(__name__)
    exec_fn = (
        functools.partial(parallel_exec, num_proc=num_jobs) if num_jobs > 1 else serial_exec
    )
    categories = (
        extract_category_ids(config.id_file) if config.id_file else config.queries
    )

    def dispatch(tasks):
        for i in range(0, len(tasks), max_per_minute):
            start = clock()
            exec_fn(_plain_download, tasks[i : i + max_per_minute])
            if i + max_per_minute < len(tasks):
                remaining = 60 - (clock() - start)
                if remaining > 0:
                    sleep(remaining)

    n_files = 0
    for category, spec in categories.items():
        out_dir = os.path.join(out_root, category)
        os.makedirs(out_dir, exist_ok=True)
        pages = (
            inquirer.ids_to_files(spec, config.fields_to_save, config.min_duration)
            if config.id_file
            else inquirer.queries_to_files(spec, config.fields_to_save, config.min_duration)
        )
        for results in pages:
            sounds = list(results)
            logger.info(f"{category}: {len(sounds)} files")
            dispatch([(s, f"{s.id}.wav", out_dir) for s in sounds])
            info = {field: [getattr(s, field) for s in sounds] for field in config.fields_to_save}
            if info:
                update_csv(info, os.path.join(out_dir, f"{category}.csv"), sort_label="id", sep="\t")
            n_files += len(sounds)
    return n_files

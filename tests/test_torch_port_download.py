"""The port's corpus acquisition (``disco_tpu_torch/datagen/download.py``,
``disco-torch-download``) against the JAX package's, both driven by one
fake Freesound client — zero network.

* ``tests/test_download.py``'s cases, run on each package through the
  ``pkg`` fixture;
* one download through both packages: the same client calls (their
  kwargs, in order), the same files and byte-identical csv trees, the same
  rate-limiter sleeps under an injected clock (one case at
  ``num_jobs=2``, through a process pool);
* ``get_missing`` / ``clean_info`` on the same tree, and both CLIs'
  ``--list-urls``, ``--clean``, Freesound (``from_token`` monkeypatched)
  and missing-flag lines and exit codes.

The fakes are module-level classes, so a pool worker unpickles them.
"""
import csv
import logging
import os
from pathlib import Path

import pytest

from disco_tpu.cli import download as jcli
from disco_tpu.datagen import download as jdownload
from disco_tpu_torch.cli import download as tcli
from disco_tpu_torch.datagen import download as tdownload

PACKAGES = {"jax": (jdownload, jcli), "port": (tdownload, tcli)}


class FakeSound:
    def __init__(self, sid, name="snd"):
        self.id = sid
        self.name = name
        self.retrieved = []

    def retrieve(self, output_dir, name=None):
        path = os.path.join(output_dir, name)
        with open(path, "wb") as fh:
            fh.write(b"RIFFfake" + name.encode())
        self.retrieved.append(path)


class BrokenSound(FakeSound):
    def retrieve(self, output_dir, name=None):
        raise OSError("connection reset")


class FakePage:
    def __init__(self, sounds, has_next):
        self.sounds = sounds
        self._next = "url" if has_next else None

    def as_dict(self):
        return {"next": self._next}

    def __iter__(self):
        return iter(self.sounds)


class FakeClient:
    """freesound.FreesoundClient-shaped test double; serves ``pages`` pages
    of ``per_page`` sounds, the last with no next page.  A sound whose id
    is in ``broken`` fails its download (the downloader logs and goes on)."""

    def __init__(self, per_page=3, pages=2, broken=()):
        self.calls = []
        self.per_page = per_page
        self.pages = pages
        self.broken = set(broken)

    def text_search(self, **kwargs):
        self.calls.append(kwargs)
        page = kwargs.get("page", 1)
        base = 100 * page
        ids = [str(base + i) for i in range(self.per_page)]
        return FakePage([(BrokenSound if s in self.broken else FakeSound)(s, name=f"n{s}")
                         for s in ids], has_next=page < self.pages)


@pytest.fixture(params=list(PACKAGES))
def pkg(request):
    """The download module of each package."""
    return PACKAGES[request.param][0]


def _tree(root) -> dict:
    """relative path -> bytes of every file under ``root``."""
    root = Path(root)
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


# ------------------------------------------------- tests/test_download.py's cases
def test_config_promotes_string_queries(pkg):
    cfg = pkg.DownloadConfig(queries={"fan": "fan vent", "baby": ["baby cry", "infant"]})
    assert cfg.queries["fan"] == ["fan vent"]
    assert cfg.queries["baby"] == ["baby cry", "infant"]


def test_config_requires_source(pkg):
    with pytest.raises(ValueError, match='At least one of "queries" and "id_file"'):
        pkg.DownloadConfig()


def test_config_from_yaml(pkg, tmp_path):
    p = tmp_path / "c.yaml"
    p.write_text("queries:\n  fan: fan vent\nfields_to_save: ['id']\nmin_duration: 3\n")
    cfg = pkg.DownloadConfig.from_yaml(p)
    assert cfg.min_duration == 3 and cfg.fields_to_save == ("id",)
    assert cfg.queries == {"fan": ["fan vent"]}


def test_queries_pagination_yields_the_last_page(pkg):
    client = FakeClient()
    pages = list(pkg.FreesoundInquirer(client).queries_to_files(["vacuum"], ["id"], min_duration=3))
    assert len(pages) == 2
    assert client.calls[0]["filter"] == "duration:[3 TO *]"
    assert client.calls[0]["page_size"] == 150


def test_ids_batched_200(pkg):
    client = FakeClient()
    pages = list(pkg.FreesoundInquirer(client).ids_to_files([str(i) for i in range(450)], ["id"]))
    assert len(pages) == 6  # 3 id batches (200+200+50) x 2 pages each
    assert "id:(0 OR 1" in client.calls[0]["filter"]
    assert client.calls[2]["filter"].count(" OR ") == 199


def test_extract_category_ids(pkg, tmp_path):
    p = tmp_path / "ids.csv"
    p.write_text(",fan,baby\n0,11,21\n1,12,22\n2,13,\n")
    assert pkg.extract_category_ids(p) == {"fan": ["11", "12"], "baby": ["21", "22"]}


def test_update_csv_dedup_and_sort(pkg, tmp_path):
    p = tmp_path / "info.csv"
    pkg.update_csv({"id": ["3", "1"], "name": ["c", "a"]}, p, sort_label="id", sep="\t")
    pkg.update_csv({"id": ["2", "1"], "name": ["b", "a"]}, p, sort_label="id", sep="\t")
    with open(p) as fh:
        rows = list(csv.reader(fh, delimiter="\t"))
    assert rows[0] == ["id", "name"]
    assert [r[0] for r in rows[1:]] == ["1", "2", "3"]
    assert not [q for q in tmp_path.iterdir() if ".tmp." in q.name]  # no litter


def test_limit_exec_sleeps_after_quota(pkg):
    sleeps, t = [], [0.0]

    def clock():
        t[0] += 0.1
        return t[0]

    @pkg.limit_exec(max_per_minute=3, sleep=sleeps.append, clock=clock)
    def f():
        return 1

    for _ in range(7):
        f()
    assert len(sleeps) == 2 and all(55 < s < 60 for s in sleeps)
    assert f.num_exec == 1


def test_set_up_log_file(pkg, tmp_path):
    log = pkg.set_up_log(str(tmp_path / "x" / "run.log"), level=1)
    log.info("hello")
    logging.shutdown()
    assert "hello" in (tmp_path / "x" / "run.log").read_text()
    assert log.level == logging.INFO


def test_serial_exec(pkg):
    assert pkg.serial_exec(lambda a, b: a + b, [(1, 2), (3, 4)]) == [3, 7]


def test_limited_download_writes_and_swallows_errors(pkg, tmp_path):
    pkg.limited_download(FakeSound("7"), "7.wav", str(tmp_path))
    pkg.limited_download(BrokenSound("8"), "8.wav", str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["7.wav"]


# ------------------------------------------------- one download through both
#: name -> (config kwargs, client kwargs, download kwargs)
DOWNLOADS = {
    "queries": (dict(queries={"fan": "fan vent", "baby": ["baby cry", "infant"]},
                     fields_to_save=["id", "name"], min_duration=3), {}, {}),
    "ids": (dict(fields_to_save=["id"]), {}, {}),
    "rate_limited": (dict(queries={"fan": "fan vent"}, fields_to_save=["id"]),
                     dict(per_page=5), dict(max_per_minute=2)),
    "broken_and_no_fields": (dict(queries={"fan": "fan vent"}), dict(broken={"101"}), {}),
    "num_jobs_2": (dict(queries={"fan": ["fan vent", "fan"]}, fields_to_save=["id", "name"]),
                   dict(per_page=4), dict(num_jobs=2, max_per_minute=3)),
}


def _download(pkg_name, case, tmp_path):
    """(files written, client calls, sleeps, clock reads) of one download."""
    mod = PACKAGES[pkg_name][0]
    cfg_kw, client_kw, dl_kw = DOWNLOADS[case]
    root = tmp_path / pkg_name
    root.mkdir()
    if case == "ids":
        (root / "ids.csv").write_text(",fan,baby\n0,11,21\n1,12,22\n2,13,\n")
        cfg_kw = dict(cfg_kw, id_file=str(root / "ids.csv"))
    client, sleeps, t = FakeClient(**client_kw), [], [0.0]

    def clock():
        t[0] += 1.5
        return t[0]

    n = mod.download_freesound(mod.DownloadConfig(**cfg_kw), mod.FreesoundInquirer(client),
                               str(root / "out"), sleep=sleeps.append, clock=clock, **dl_kw)
    return n, _tree(root / "out"), client.calls, sleeps, t[0]


@pytest.mark.parametrize("case", list(DOWNLOADS))
def test_download_matches_jax(case, tmp_path):
    ours = _download("port", case, tmp_path)
    theirs = _download("jax", case, tmp_path)
    assert ours == theirs
    n, tree, calls, sleeps, _ = ours
    n_pages = len(calls)
    assert n == n_pages * FakeClient(**DOWNLOADS[case][1]).per_page
    # one file per category and id (two queries of a category find the same ids)
    per_page = FakeClient(**DOWNLOADS[case][1]).per_page
    cats = ("fan", "baby") if case in ("queries", "ids") else ("fan",)
    want = {f"{c}/{p * 100 + i}.wav" for c in cats for p in (1, 2) for i in range(per_page)}
    want -= {f"fan/{s}.wav" for s in DOWNLOADS[case][1].get("broken", ())}
    assert {k for k in tree if k.endswith(".wav")} == want
    if DOWNLOADS[case][0].get("fields_to_save"):
        assert {k for k in tree if k.endswith(".csv")} >= {f"{c}/{c}.csv" for c in ("fan",)}
    else:
        assert not [k for k in tree if k.endswith(".csv")]
    if case == "rate_limited":  # 5 sounds a page, batches of 2: 2 sleeps a page
        assert sleeps == [58.5] * 4
    if case == "num_jobs_2":
        assert len(sleeps) == n_pages and set(sleeps) == {58.5}
        with open(Path(tmp_path / "port" / "out" / "fan" / "fan.csv")) as fh:
            rows = list(csv.reader(fh, delimiter="\t"))
        assert rows[0] == ["id", "name"] and len(rows) == 1 + 8  # deduped over 2 queries


def test_reconciliation_matches_jax(tmp_path):
    out = {}
    for name, (mod, _) in PACKAGES.items():
        d = tmp_path / name / "fan"
        d.mkdir(parents=True)
        for f in ("11.wav", "12_take2.wav", "99.wav", "notes.txt"):
            (d / f).write_bytes(b"x")
        (d / "fan.csv").write_text("id\tname\n11\ta\n12\tb\n13\tc\n\n")
        missing = mod.get_missing(d / "fan.csv")
        dropped = mod.clean_info(d / "fan.csv")
        (d / "empty.csv").write_text("")
        out[name] = (missing, dropped, mod.clean_info(d / "empty.csv"),
                     mod.get_missing(d / "empty.csv"), _tree(d))
    assert out["port"] == out["jax"]
    assert out["port"][:4] == (["99.wav", "notes.txt"], 2, 0, [])  # 13 and the blank row


# ------------------------------------------------------------------- the CLIs
def _cli(pkg_name, argv, capsys):
    """(exit code or SystemExit text, stdout) of one CLI call."""
    main = PACKAGES[pkg_name][1].main
    try:
        code = main(argv)
    except SystemExit as e:
        code = ("SystemExit", str(e.code))
    return code, capsys.readouterr().out


def test_console_script_is_registered():
    import tomllib

    root = Path(__file__).resolve().parents[1]
    scripts = tomllib.loads((root / "pyproject.toml").read_text())["project"]["scripts"]
    assert scripts["disco-torch-download"] == "disco_tpu_torch.cli.download:main"
    assert scripts["disco-download"] == "disco_tpu.cli.download:main"


def test_cli_parsers_match():
    def actions(p):
        return [(a.dest, tuple(a.option_strings), a.default, a.type, a.nargs)
                for a in p._actions]

    assert actions(tcli.build_parser()) == actions(jcli.build_parser())
    assert "--device" not in tcli.build_parser().format_help()


def test_cli_list_urls_matches_jax(capsys):
    ours, theirs = (_cli(p, ["--list-urls"], capsys) for p in ("port", "jax"))
    assert ours == theirs
    assert ours[0] == 0 and len(ours[1].splitlines()) == 4
    assert ours[1].splitlines() == tdownload.LIBRISPEECH_URLS + [tdownload.ZENODO_DISCO_NOISE_URL]


def test_cli_clean_matches_jax(tmp_path, capsys):
    for name in PACKAGES:
        for cat, wav, rows in (("fan", "11.wav", "11\ta\n13\tc\n"), ("baby", "21.wav", "21\tb\n")):
            d = tmp_path / name / cat
            d.mkdir(parents=True)
            (d / wav).write_bytes(b"x")
            (d / f"{cat}.csv").write_text("id\tname\n" + rows)
    ours = _cli("port", ["--clean", str(tmp_path / "port")], capsys)
    theirs = _cli("jax", ["--clean", str(tmp_path / "jax")], capsys)
    assert ours == theirs == (0, "dropped 1 stale csv rows\n")
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")


@pytest.mark.parametrize("argv", [[], ["--token", "t"], ["--config", "c.yaml"]])
def test_cli_missing_token_or_config_matches_jax(argv, capsys):
    ours, theirs = (_cli(p, argv, capsys) for p in ("port", "jax"))
    assert ours == theirs == (
        ("SystemExit", "--token and --config are required for Freesound downloads"), "")


@pytest.mark.parametrize("jobs", ["1", "2"])
def test_cli_freesound_matches_jax(jobs, tmp_path, capsys, monkeypatch):
    cfg = tmp_path / "c.yaml"
    cfg.write_text("queries:\n  fan: fan vent\n  rain: [rain, drizzle]\n"
                   "fields_to_save: [id, name]\n")
    tokens = []

    def from_token(cls, token, authentication_method="oauth"):
        tokens.append((token, authentication_method))
        return cls(FakeClient())

    out = {}
    for name, (mod, _) in PACKAGES.items():
        monkeypatch.setattr(mod.FreesoundInquirer, "from_token", classmethod(from_token))
        res = _cli(name, ["-t", "tok", "-c", str(cfg), "-o", str(tmp_path / name), "-j", jobs],
                   capsys)
        out[name] = (res, _tree(tmp_path / name))
    assert out["port"] == out["jax"]
    assert out["port"][0] == (0, "downloaded 18 files\n")
    assert tokens == [("tok", "oauth")] * 2
    assert {k for k in out["port"][1] if k.endswith(".csv")} == {"fan/fan.csv", "rain/rain.csv"}

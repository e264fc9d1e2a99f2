"""The port as an installed program: its wheel, its zipapp and its image.

The JAX package ships a console script, a zipapp (``make build``) and an
image (``Dockerfile``); the port ships the same three (``downloader-torch``,
``make build-torch``, ``Dockerfile.cuda``). These tests build the wheel
offline and the zipapp from this checkout, install or unpack nothing
outside ``tmp_path``, and run each from a directory outside the checkout
with no ``PYTHONPATH`` pointing at it. Where the JAX package has the same
artifact (the zipapp and its RC4 core), the reference and the port are
cases of one parametrised test. The kernel library cannot be built here
(no nvcc): a file of the right name stands in for it where the test only
checks which file the port picks, and a fake ``nvcc`` stands in for the
compiler where the test checks what the port hands it.
"""

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import textwrap
import time
import zipfile
from pathlib import Path

import pytest

from downloader_tpu_torch.fetch import rc4_native
from downloader_tpu_torch.parallel import sha1_cuda
from downloader_tpu_torch.utils import usercache

REPO = Path(__file__).resolve().parent.parent
TIMEOUT = 300
SKIP = shutil.ignore_patterns("__pycache__", "*.pyc", "*.so", "*.tmp", "*.egg-info")
# the zipapp of each package: its make target, its archive, its package
ARCHIVES = {
    "ref": ("build", "downloader.pyz", "downloader_tpu"),
    "port": ("build-torch", "downloader-torch.pyz", "downloader_tpu_torch"),
}


def run(args, *, env=None, cwd=None, check=True):
    done = subprocess.run(
        args, env=env, cwd=cwd, capture_output=True, text=True, timeout=TIMEOUT
    )
    if check:
        assert done.returncode == 0, done.stdout + done.stderr
    return done


def no_nvcc_path() -> str:
    """This host's PATH without any directory that holds an nvcc."""
    return os.pathsep.join(
        part for part in os.environ.get("PATH", "").split(os.pathsep)
        if part and not (Path(part) / "nvcc").exists()
    )


def outside_env(tmp_path: Path, **knobs) -> dict:
    """A child's environment away from the checkout: a fresh HOME and
    XDG cache under ``tmp_path``, no PYTHONPATH, no nvcc (an empty
    CUDA_HOME and a PATH without one), and ``knobs``."""
    env = {
        name: value for name, value in os.environ.items()
        if name not in ("PYTHONPATH", "XDG_CACHE_HOME", "HOME", "CUDA_HOME", "PATH")
    }
    empty = tmp_path / "cuda-home"
    empty.mkdir(exist_ok=True)
    env.update(
        HOME=str(tmp_path / "home"), XDG_CACHE_HOME=str(tmp_path / "xdg"),
        CUDA_HOME=str(empty), PATH=no_nvcc_path(),
    )
    env.update(knobs)
    return env


def in_archive(code: str, archive: Path) -> str:
    """Python source that imports from ``archive`` first, then runs ``code``."""
    return f"import sys\nsys.path.insert(0, {str(archive)!r})\n" + textwrap.dedent(code)


@pytest.fixture(scope="module")
def wheel(tmp_path_factory) -> Path:
    """The wheel built offline from a copy of this checkout's sources."""
    base = tmp_path_factory.mktemp("wheel")
    source = base / "src"
    source.mkdir()
    for name in ("pyproject.toml", "README.md"):
        shutil.copy(REPO / name, source / name)
    for package in ("downloader_tpu", "downloader_tpu_torch"):
        shutil.copytree(REPO / package, source / package, ignore=SKIP)
    run([sys.executable, "-m", "pip", "wheel", "--no-deps", "--no-build-isolation",
         "--no-index", "-w", str(base / "dist"), str(source)], cwd=base)
    (built,) = (base / "dist").glob("*.whl")
    return built


@pytest.fixture(scope="module")
def site(wheel, tmp_path_factory) -> Path:
    """The wheel installed into a target directory."""
    target = tmp_path_factory.mktemp("install") / "site"
    run([sys.executable, "-m", "pip", "install", "--no-deps", "--no-index",
         "--target", str(target), str(wheel)])
    return target


@pytest.fixture(scope="module")
def archives(tmp_path_factory) -> dict:
    """Each package's zipapp, built by its make target into a temp BINDIR,
    in a copy of the checkout (`make build` compiles the JAX package's
    RC4 core in place, which tests/test_build.py does in the checkout,
    maybe at the same time in another worker) and with no nvcc, so that
    the port's archive holds no kernel library on any host."""
    tree = tmp_path_factory.mktemp("tree")
    shutil.copy(REPO / "Makefile", tree)
    for name in ("hack", "downloader_tpu", "downloader_tpu_torch"):
        shutil.copytree(REPO / name, tree / name, ignore=SKIP)
    env = outside_env(tmp_path_factory.mktemp("make"))
    built = {}
    for kind, (target, name, _) in ARCHIVES.items():
        bindir = tmp_path_factory.mktemp(f"bin-{kind}")
        run(["make", target, f"BINDIR={bindir}"], env=env, cwd=tree)
        built[kind] = bindir / name
    return built


@pytest.fixture
def pyz(archives) -> Path:
    return archives["port"]


# -- the wheel and its console script ---------------------------------------------


def test_wheel_names_both_scripts_and_ships_sources_not_libraries(wheel):
    assert wheel.name.endswith("-py3-none-any.whl")
    with zipfile.ZipFile(wheel) as archive:
        names = archive.namelist()
        (entry_points,) = [n for n in names if n.endswith(".dist-info/entry_points.txt")]
        scripts = archive.read(entry_points).decode()
    assert "downloader = downloader_tpu.cli:main" in scripts
    assert "downloader-torch = downloader_tpu_torch.cli:main" in scripts
    for shipped in ("downloader_tpu_torch/parallel/csrc/sha1.cu",
                    "downloader_tpu_torch/fetch/_rc4.c", "downloader_tpu/fetch/_rc4.c"):
        assert shipped in names
    assert [n for n in names if n.endswith(".so")] == []


def test_installed_console_script_runs_from_outside_the_checkout(site, tmp_path):
    env = outside_env(tmp_path, PYTHONPATH=str(site))
    done = run([str(site / "bin" / "downloader-torch"), "--help"], env=env, cwd=tmp_path)
    assert "download-once" in done.stdout and "serve" in done.stdout
    where = run([sys.executable, "-c", "import downloader_tpu_torch as p; print(p.__file__)"],
                env=env, cwd=tmp_path)
    assert Path(where.stdout.strip()).is_relative_to(site)


# -- the zipapps -----------------------------------------------------------------


@pytest.mark.parametrize("kind", sorted(ARCHIVES))
def test_zipapp_build(archives, kind):
    _, _, package = ARCHIVES[kind]
    with zipfile.ZipFile(archives[kind]) as archive:
        names = archive.namelist()
        main = archive.read("__main__.py").decode()
    assert f"from {package}.cli import main" in main
    assert any(n.startswith(f"{package}/") for n in names)
    done = run([sys.executable, str(archives[kind]), "--help"], cwd=archives[kind].parent)
    assert "download-once" in done.stdout


@pytest.mark.parametrize("kind", sorted(ARCHIVES))
def test_zipapp_ships_and_extracts_native_rc4(archives, kind, tmp_path):
    """The .so ships inside the archive and rc4_native extracts it to
    the cache on first load, keyed by its hash, and takes the same file
    on the next run."""
    _, _, package = ARCHIVES[kind]
    with zipfile.ZipFile(archives[kind]) as archive:
        names = archive.namelist()
    if f"{package}/fetch/_rc4.so" not in names:
        pytest.skip("no C compiler on this host: archive has no .so")
    code = in_archive(f"""
        from {package}.fetch.rc4_native import RC4
        rc4 = RC4(b'Key')
        assert rc4.crypt(b'Plaintext').hex() == 'bbf316e8d940af0ad3'
        assert rc4._native is not None, 'zip fell back to pure python'
    """, archives[kind])
    env = {**os.environ, "XDG_CACHE_HOME": str(tmp_path / "cache")}
    run([sys.executable, "-c", code], env=env, cwd=tmp_path)
    extracted = list((tmp_path / "cache" / package).glob("_rc4-*.so"))
    assert len(extracted) == 1, "native core was not extracted to the cache dir"
    with zipfile.ZipFile(archives[kind]) as archive:
        shipped = archive.read(f"{package}/fetch/_rc4.so")
    assert extracted[0].name == f"_rc4-{hashlib.sha1(shipped).hexdigest()[:12]}.so"
    run([sys.executable, "-c", code], env=env, cwd=tmp_path)
    assert list((tmp_path / "cache" / package).glob("_rc4-*.so")) == extracted


def test_port_archive_holds_the_port_alone(pyz):
    with zipfile.ZipFile(pyz) as archive:
        names = archive.namelist()
    assert [n for n in names if n.startswith("downloader_tpu/")] == []
    assert set(n.split("/")[0] for n in names) == {"__main__.py", "downloader_tpu_torch"}
    assert "downloader_tpu_torch/parallel/csrc/sha1.cu" in names


def test_http_help_from_the_archive_imports_no_torch(pyz, tmp_path):
    code = in_archive(f"""
        import runpy
        sys.argv = [{str(pyz)!r}, 'download-once', '--help']
        try:
            runpy.run_path({str(pyz)!r}, run_name='__main__')
        except SystemExit as exit:
            assert exit.code == 0, exit.code
        assert 'torch' not in sys.modules, 'the HTTP path imported torch'
        assert 'downloader_tpu_torch.parallel' not in sys.modules
    """, pyz)
    done = run([sys.executable, "-c", code], env=outside_env(tmp_path), cwd=tmp_path)
    assert "--url" in done.stdout


def test_fleet_from_the_archive_puts_the_archive_on_pythonpath(pyz, tmp_path):
    code = in_archive(f"""
        import json
        from downloader_tpu_torch.daemon import fleet
        supervisor = fleet.FleetSupervisor(
            fleet.FleetConfig(workers=1), heartbeat_dir={str(tmp_path)!r})
        handle = supervisor._build_handle(supervisor._slots[0])
        print(json.dumps([fleet.__file__, handle.argv, handle.env['PYTHONPATH']]))
    """, pyz)
    done = run([sys.executable, "-c", code], env=outside_env(tmp_path), cwd=tmp_path)
    module, argv, pythonpath = json.loads(done.stdout)
    assert module.startswith(str(pyz) + os.sep)
    assert argv == [sys.executable, "-m", "downloader_tpu_torch", "serve"]
    assert pythonpath.split(os.pathsep)[0] == str(pyz)


# -- the kernel library inside and outside an archive -----------------------------


KERNEL_REPORT = """
    import json, subprocess
    def refuse(*args, **kwargs):
        raise AssertionError(f"ran {args[0][0]}")
    subprocess.run = refuse
    from downloader_tpu_torch.parallel import sha1_cuda
    try:
        path = str(sha1_cuda.build())
    except RuntimeError as exc:
        path = f"RuntimeError: {exc}"
    print(json.dumps([sha1_cuda.library_name(), path, sha1_cuda.origin,
                      sha1_cuda.compile_s]))
"""


def kernel_report(code_base: Path, tmp_path: Path, archive: bool) -> list:
    """``sha1_cuda.build()`` in a child that imports the port from
    ``code_base`` (an archive, or a directory that holds the package) with
    no nvcc and with ``subprocess.run`` refused: [library name, the
    path it returned or the error, origin, compile seconds]."""
    if archive:
        code, env = in_archive(KERNEL_REPORT, code_base), outside_env(tmp_path)
    else:
        code = textwrap.dedent(KERNEL_REPORT)
        env = outside_env(tmp_path, PYTHONPATH=str(code_base))
    return json.loads(run([sys.executable, "-c", code], env=env, cwd=tmp_path).stdout)


def with_library(pyz: Path, tmp_path: Path, place: str, name: str, data: bytes) -> Path:
    """The port with a library file called ``name``: beside the module in
    an unpacked copy (returns the directory that holds the package), or
    inside a copy of the archive (returns the archive)."""
    if place == "beside":
        base = tmp_path / "site"
        shutil.copytree(REPO / "downloader_tpu_torch", base / "downloader_tpu_torch", ignore=SKIP)
        (base / "downloader_tpu_torch" / "parallel" / name).write_bytes(data)
        return base
    copy = tmp_path / "with-library.pyz"
    shutil.copy(pyz, copy)
    with zipfile.ZipFile(copy, "a") as archive:
        archive.writestr(f"downloader_tpu_torch/parallel/{name}", data)
    return copy


def test_archive_reads_the_kernel_source_of_the_checkout(pyz, tmp_path):
    report = kernel_report(pyz, tmp_path, archive=True)
    name = report[0]
    assert name == sha1_cuda.library_name()
    digest = hashlib.sha256(sha1_cuda.SOURCE.read_bytes()).hexdigest()[:16]
    assert name == f"libsha1-{digest}.so"


def test_archive_without_library_or_nvcc_raises_naming_both(pyz, tmp_path):
    name, error, origin, compile_s = kernel_report(pyz, tmp_path, archive=True)
    assert error.startswith("RuntimeError: nvcc not found"), error
    assert name in error and "prebuilt" in error
    assert origin is None and compile_s is None


@pytest.mark.parametrize("place", ["beside", "archive"])
def test_library_of_the_source_is_taken_without_nvcc(pyz, tmp_path, place):
    name, data = sha1_cuda.library_name(), b"\x7fELF stands in for the kernel library"
    base = with_library(pyz, tmp_path, place, name, data)
    _, path, origin, compile_s = kernel_report(base, tmp_path, archive=place == "archive")
    assert compile_s is None
    if place == "beside":
        assert (origin, path) == ("prebuilt", str(base / "downloader_tpu_torch" / "parallel" / name))
    else:
        cached = tmp_path / "xdg" / "downloader_tpu_torch" / name
        assert (origin, path) == ("archive", str(cached))
        assert cached.read_bytes() == data
        before = cached.stat().st_mtime_ns
        assert kernel_report(base, tmp_path, archive=True)[1:3] == [str(cached), "archive"]
        assert cached.stat().st_mtime_ns == before, "the extracted library was written again"
        assert sorted(p.name for p in cached.parent.iterdir()) == [name]


@pytest.mark.parametrize("place", ["beside", "archive"])
def test_library_of_another_source_is_ignored(pyz, tmp_path, place):
    base = with_library(pyz, tmp_path, place, "libsha1-0123456789abcdef.so", b"stale")
    _, error, origin, _ = kernel_report(base, tmp_path, archive=place == "archive")
    assert error.startswith("RuntimeError: nvcc not found"), error
    assert origin is None


FAKE_NVCC = """#!{python}
import json, sys
out = sys.argv[sys.argv.index("-o") + 1]
source = sys.argv[-1]
with open(source, "rb") as handle:
    text = handle.read()
with open({log!r}, "w") as log:
    json.dump({{"argv": sys.argv[1:], "source": source, "sha256": __import__("hashlib").sha256(text).hexdigest()}}, log)
with open(out, "wb") as handle:
    handle.write(b"built")
"""


def fake_cuda_home(tmp_path: Path) -> tuple[Path, Path]:
    """A CUDA_HOME whose bin/nvcc records its arguments and the source it
    read to a log and writes a stand-in library: (home, log)."""
    home, log = tmp_path / "fake-cuda", tmp_path / "nvcc.json"
    (home / "bin").mkdir(parents=True)
    nvcc = home / "bin" / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable, log=str(log)))
    nvcc.chmod(0o755)
    return home, log


def test_build_step_compiles_with_the_module_flags(tmp_path):
    home, log = fake_cuda_home(tmp_path)
    out = tmp_path / "out"
    done = run([sys.executable, "-m", "downloader_tpu_torch.parallel", "--out", str(out)],
               env={**os.environ, "CUDA_HOME": str(home), "PYTHONPATH": str(REPO)}, cwd=tmp_path)
    target = out / sha1_cuda.library_name()
    assert done.stdout.strip() == str(target)
    # one copy of the module: no runpy warning of a second one
    assert "RuntimeWarning" not in done.stderr, done.stderr
    assert target.read_bytes() == b"built"
    record = json.loads(log.read_text())
    assert record["argv"][: len(sha1_cuda.NVCC_FLAGS)] == list(sha1_cuda.NVCC_FLAGS)
    assert record["source"] == str(sha1_cuda.SOURCE)
    assert sorted(p.name for p in out.iterdir()) == [target.name]


def test_archive_compiles_from_the_source_written_to_the_cache(pyz, tmp_path):
    home, log = fake_cuda_home(tmp_path)
    code = in_archive("""
        import json
        from downloader_tpu_torch.parallel import sha1_cuda
        path = sha1_cuda.build()
        print(json.dumps([str(path), sha1_cuda.origin, sha1_cuda.compile_s]))
    """, pyz)
    done = run([sys.executable, "-c", code], env=outside_env(tmp_path, CUDA_HOME=str(home)),
               cwd=tmp_path)
    path, origin, compile_s = json.loads(done.stdout)
    cache = tmp_path / "xdg" / "downloader_tpu_torch"
    assert (path, origin) == (str(cache / sha1_cuda.library_name()), "compiled")
    assert compile_s > 0
    record = json.loads(log.read_text())
    assert Path(record["source"]).parent == cache and record["source"].endswith(".cu")
    assert record["sha256"] == hashlib.sha256(sha1_cuda.SOURCE.read_bytes()).hexdigest()
    # the written-out source is gone; only the library stays
    assert sorted(p.name for p in cache.iterdir()) == [sha1_cuda.library_name()]


# -- the per-user cache ----------------------------------------------------------


def test_both_libraries_resolve_the_cache_through_one_helper(tmp_path, monkeypatch):
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    cache = tmp_path / "xdg" / "downloader_tpu_torch"
    assert usercache.cache_dir() == str(cache)
    assert rc4_native._cache_dir() == str(cache)
    assert sha1_cuda._build_dir(tmp_path / "site-packages") == cache
    monkeypatch.setattr(usercache, "cache_dir", lambda: str(tmp_path / "elsewhere"))
    assert rc4_native._cache_dir() == str(tmp_path / "elsewhere")
    assert sha1_cuda._build_dir(tmp_path / "site-packages") == tmp_path / "elsewhere"


CACHE_RACE = """
import sys, time
from downloader_tpu_torch.utils import usercache
start, rounds = float(sys.argv[1]), int(sys.argv[2])
while time.time() < start:
    pass
print(sorted({usercache.cache_dir() for _ in range(rounds)}))
"""


def test_processes_resolving_the_cache_at_once_all_get_the_xdg_place(tmp_path):
    """The workers of a fleet resolve the cache at the same moment; each
    checks the place with a probe of its own, so none sees another's
    probe vanish and none falls back to a second cache."""
    env = {**os.environ, "XDG_CACHE_HOME": str(tmp_path / "xdg"), "PYTHONPATH": str(REPO)}
    start = time.time() + 3.0
    children = [
        subprocess.Popen([sys.executable, "-c", CACHE_RACE, str(start), "3000"], env=env,
                         cwd=tmp_path, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(4)
    ]
    outputs = [child.communicate(timeout=TIMEOUT) for child in children]
    for child, (out, err) in zip(children, outputs):
        assert child.returncode == 0, err
        assert out.strip() == repr([str(tmp_path / "xdg" / "downloader_tpu_torch")]), out
    assert list((tmp_path / "xdg" / "downloader_tpu_torch").iterdir()) == []


def test_place_writes_reuses_and_refuses(tmp_path, monkeypatch):
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    cache = tmp_path / "xdg" / "downloader_tpu_torch"
    first = usercache.place("lib.so", b"one")
    assert first == cache / "lib.so" and first.read_bytes() == b"one"
    before = first.stat().st_mtime_ns
    assert usercache.place("lib.so", b"one") == first
    assert first.stat().st_mtime_ns == before, "equal bytes were written again"
    assert usercache.place("lib.so", b"two") == first and first.read_bytes() == b"two"
    # a file that fails loads is neither reused nor written, and no temp file stays
    assert usercache.place("lib.so", b"two", loads=lambda path: False) is None
    assert usercache.place("other.so", b"three", loads=lambda path: False) is None
    assert sorted(p.name for p in cache.iterdir()) == ["lib.so"]
    assert first.read_bytes() == b"two"


def test_nvcc_lookup_is_one_helper(tmp_path, monkeypatch):
    home, _ = fake_cuda_home(tmp_path)
    monkeypatch.setenv("CUDA_HOME", str(home))
    assert usercache.find_nvcc() == sha1_cuda._nvcc() == str(home / "bin" / "nvcc")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "empty"))
    monkeypatch.setenv("PATH", no_nvcc_path())
    assert usercache.find_nvcc() is None
    with pytest.raises(RuntimeError, match="nvcc not found"):
        sha1_cuda._nvcc()
    script = (REPO / "hack" / "build_torch_pyz.py").read_text()
    assert "usercache.find_nvcc()" in script and "def find_nvcc" not in script


def test_unusable_home_falls_back_to_the_per_uid_tempdir(tmp_path, monkeypatch):
    blocker = tmp_path / "blocker"
    blocker.write_text("not a directory")
    monkeypatch.delenv("XDG_CACHE_HOME", raising=False)
    monkeypatch.setenv("HOME", str(blocker / "home"))
    fake_tmp = tmp_path / "tmp"
    fake_tmp.mkdir()
    monkeypatch.setattr(usercache.tempfile, "gettempdir", lambda: str(fake_tmp))
    path = usercache.cache_dir()
    assert path == str(fake_tmp / f"downloader_tpu_torch-{os.getuid()}")
    assert os.stat(path).st_mode & 0o777 == 0o700


def test_last_resort_mkdtemp_is_removed_at_exit(tmp_path, monkeypatch):
    """With the XDG cache and the per-uid tempdir unusable (the latter
    squatted: group/other-writable) each process gets one mkdtemp,
    shared by both libraries and registered for removal at exit."""
    blocker = tmp_path / "blocker"
    blocker.write_text("not a directory")
    monkeypatch.setenv("XDG_CACHE_HOME", str(blocker / "cache"))
    fake_tmp = tmp_path / "tmp"
    fake_tmp.mkdir()
    squatted = fake_tmp / f"downloader_tpu_torch-{os.getuid()}"
    squatted.mkdir(mode=0o700)
    squatted.chmod(0o777)
    monkeypatch.setattr(usercache.tempfile, "gettempdir", lambda: str(fake_tmp))
    monkeypatch.setattr(usercache, "_fallback", None)
    registered = []
    monkeypatch.setattr(
        usercache.atexit, "register", lambda fn, *a, **kw: registered.append((fn, a, kw))
    )
    path = usercache.cache_dir()
    try:
        assert os.path.dirname(path) == str(fake_tmp)
        assert os.path.basename(path).startswith("downloader_tpu_torch-")
        assert path != str(squatted)
        assert rc4_native._cache_dir() == path
        assert str(sha1_cuda._build_dir(tmp_path)) == path
        assert len(registered) == 1, "one directory a process"
        fn, args, kwargs = registered[0]
        assert fn is shutil.rmtree and args[0] == path
        assert kwargs.get("ignore_errors") is True
        fn(*args, **kwargs)
        assert not os.path.exists(path)
    finally:
        shutil.rmtree(path, ignore_errors=True)


# -- the image, the Makefile and CI, read statically ------------------------------


def dockerfile_stages() -> list[list[str]]:
    """Dockerfile.cuda's instructions (continuation lines joined, comments
    dropped), split into stages at each FROM; what comes before the first
    FROM is stage 0."""
    text = (REPO / "Dockerfile.cuda").read_text()
    lines = [line for line in text.splitlines() if not line.lstrip().startswith("#")]
    joined = re.sub(r"\\\n\s*", " ", "\n".join(lines))
    stages: list[list[str]] = [[]]
    for line in filter(None, (line.strip() for line in joined.splitlines())):
        if line.startswith("FROM "):
            stages.append([])
        stages[-1].append(line)
    return stages


def test_cuda_image_builds_in_two_stages_and_runs_as_a_user():
    head, builder, runtime = dockerfile_stages()
    # the versions are constants, as in the JAX package's Dockerfile
    assert head == [] and not [line for line in builder + runtime if line.startswith("ARG")]
    devel = re.fullmatch(r"FROM nvidia/cuda:(12\.8\.\d+)-devel-ubuntu24\.04 AS builder",
                         builder[0])
    assert devel, builder[0]
    assert re.fullmatch(rf"FROM nvidia/cuda:{re.escape(devel.group(1))}-(base|runtime)"
                        r"-ubuntu24\.04", runtime[0]), runtime[0]
    build = " ".join(builder)
    assert "python -m downloader_tpu_torch.parallel --out /dist" in build
    assert "pip wheel --no-deps" in build
    users = [line.split()[1] for line in runtime if line.startswith("USER ")]
    assert users == ["downloader"]
    assert "useradd --create-home --uid 1000 downloader" in " ".join(runtime)
    assert [line for line in runtime if line.startswith("ENTRYPOINT")] == [
        'ENTRYPOINT ["downloader-torch"]']
    assert [line for line in runtime if line.startswith("CMD")] == ['CMD ["serve"]']
    run_stage = " ".join(runtime)
    assert "python3 -m venv /opt/venv" in run_stage
    assert re.search(r'pip install --no-cache-dir "torch==2\.11\.0"\s+'
                     r"--index-url https://download\.pytorch\.org/whl/cu128", run_stage), run_stage
    assert 'cp /tmp/dist/libsha1-*.so "$package/parallel/"' in run_stage
    assert 'cp /tmp/dist/_rc4.so "$package/fetch/"' in run_stage
    assert "nvcc" not in run_stage and "devel" not in run_stage


def test_cuda_image_names_only_make_targets_that_exist():
    makefile = (REPO / "Makefile").read_text()
    # a make command starts an instruction or follows && (not "install make")
    commands = " ".join(" ".join(stage) for stage in dockerfile_stages())
    named = re.findall(r"(?:^|RUN|&&)\s+make ([\w-]+)", commands)
    assert named
    for target in named:
        assert re.search(rf"^{re.escape(target)}:", makefile, re.M), target


def test_makefile_builds_the_port_through_its_own_steps():
    makefile = (REPO / "Makefile").read_text()
    for target in ("dep-torch", "native-torch", "kernel-torch", "build-torch",
                   "analyze-torch", "docker-build-cuda"):
        assert re.search(rf"^{target}:", makefile, re.M), target
    assert "-m downloader_tpu_torch.parallel --out" in makefile
    assert "hack/build_torch_pyz.py" in makefile
    assert "-m downloader_tpu_torch.analysis" in makefile
    # the kernel's flags live in sha1_cuda.NVCC_FLAGS only
    rules = [line for line in makefile.splitlines() if not line.lstrip().startswith("#")]
    assert not [line for line in rules if "nvcc" in line or "sm_90a" in line or "-gencode" in line]


def test_fmt_gate_covers_the_port():
    fmt_paths = re.search(r"^FMT_PATHS := (.*)$", (REPO / "Makefile").read_text(), re.M)
    paths = fmt_paths.group(1).split()
    port = ["downloader_tpu_torch", "chip_smoke.py", "hack/build_torch_pyz.py"]
    assert set(port) <= set(paths), paths
    run([sys.executable, str(REPO / "hack" / "fmt.py"), *port], cwd=REPO)


def test_ci_tests_job_installs_torch():
    yaml = pytest.importorskip("yaml")
    ci = yaml.safe_load((REPO / ".circleci" / "config.yml").read_text())
    installs = [
        step["run"]["command"] for step in ci["jobs"]["tests"]["steps"]
        if isinstance(step, dict) and "run" in step
        and step["run"]["name"] == "install test deps"
    ]
    assert len(installs) == 1
    # the torch the CUDA image pins, as its CPU wheel
    pinned = re.search(r'"torch==([\d.]+)"', (REPO / "Dockerfile.cuda").read_text()).group(1)
    assert re.search(rf"pip install torch=={re.escape(pinned)} --index-url "
                     r"https://download\.pytorch\.org/whl/cpu", installs[0]), installs[0]
    assert "pytest numpy jax" in installs[0]

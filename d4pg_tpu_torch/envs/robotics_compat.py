"""MuJoCo-3 compatibility for gymnasium-robotics Adroit / Shadow-Hand XMLs.

Counterpart of ``d4pg_tpu/envs/robotics_compat.py``, copied (stdlib, plus
a hook on ``mujoco`` that ``install`` imports). The Adroit and
Shadow-Hand manipulation envs ship MJCF files
written for MuJoCo 2.x: they carry an ``<option apirate="...">`` attribute
that the MuJoCo 3 schema rejects, so every ``gym.make`` of an Adroit/Hand
env dies in XML parsing under MuJoCo 3. The attribute only ever controlled
the remote-render API rate — it has no physics effect — so stripping it is
semantics-preserving.

:func:`install` hooks ``mujoco.MjModel.from_xml_path`` (the single loading
funnel used by both gymnasium's ``MujocoEnv`` and gymnasium-robotics'
``MujocoRobotEnv``): when a model file contains ``apirate``, the loader is
redirected to a shadow copy of its directory in which every ``.xml`` has
the attribute stripped and every other entry (mesh/texture dirs) is
symlinked back to the original package assets. Clean files load through
the original code path untouched.
"""

from __future__ import annotations

import hashlib
import os
import re
import stat
import tempfile

_APIRATE = re.compile(rb'\s+apirate="[^"]*"')
_shadow_dirs: dict[str, str] = {}
_dir_needs_patch: dict[str, bool] = {}
_installed = False


def _needs_patch(src_dir: str) -> bool:
    """True if any XML in ``src_dir`` carries apirate — the attribute can
    live in an ``<include>``d sibling (adroit_assets.xml) rather than the
    model file itself, so the whole directory is the unit of patching."""
    cached = _dir_needs_patch.get(src_dir)
    if cached is not None:
        return cached
    found = False
    try:
        for name in os.listdir(src_dir):
            if name.endswith(".xml"):
                with open(os.path.join(src_dir, name), "rb") as f:
                    if b"apirate" in f.read():
                        found = True
                        break
    except OSError:
        found = False
    _dir_needs_patch[src_dir] = found
    return found


def _assets_root(src_dir: str) -> str:
    """Topmost ``assets`` ancestor of ``src_dir`` (the MJCF files reference
    meshes through ``../``-relative paths that stay inside the package's
    assets tree, so that tree is the unit of mirroring); ``src_dir`` itself
    when no such ancestor exists."""
    cur = src_dir
    root = src_dir
    while True:
        parent = os.path.dirname(cur)
        if parent == cur:
            break
        if os.path.basename(cur) == "assets":
            root = cur
        cur = parent
    return root


def _tree_fingerprint(root: str) -> bytes:
    """Content fingerprint of the assets tree: path + (size, mtime) of every
    XML under ``root``. Folding this into the shadow-dir tag means an
    in-place package upgrade (same install path, new MJCF) gets a FRESH
    mirror instead of being served stale patched XML — the mirror trusts
    existing entries, so the tag must change whenever the sources do."""
    parts = [root.encode()]
    for cur, _dirs, files in sorted(os.walk(root)):
        for name in sorted(files):
            if not name.endswith(".xml"):
                continue
            path = os.path.join(cur, name)
            try:
                st = os.stat(path)
            except OSError:
                continue
            parts.append(
                f"{os.path.relpath(path, root)}:{st.st_size}:{st.st_mtime_ns}".encode()
            )
    return b"\0".join(parts)


def _prune_stale_mirrors(root_tag: str, keep: str,
                         min_age_s: float = 3600.0) -> None:
    """Remove this uid's mirrors of the SAME assets tree whose content tag
    is superseded — each source change (package upgrade) mints a new tag,
    and nothing else ever deletes the orphaned tree of patched XMLs +
    symlinks. Mirrors of other trees (different ``root_tag``) may be in
    concurrent use by sibling processes and are never touched.

    In-use guard: a long-lived sibling process started BEFORE
    an in-place package upgrade still holds the old-tag path in its
    module-level ``_shadow_dirs`` cache and re-reads MJCF from it at every
    env construction; deleting it under that process breaks those
    constructions. Every process therefore holds a SHARED flock on its
    mirror's ``.inuse`` file for its lifetime (:func:`_hold_mirror_lock`);
    the pruner only removes a mirror whose lock it can take exclusively —
    crashed holders release the lock automatically. The mtime age gate
    stays as a backstop for mirrors created by versions that predate the
    lock file."""
    import fcntl
    import glob
    import shutil
    import time

    pattern = os.path.join(
        tempfile.gettempdir(),
        f"d4pg-torch-mjcf-compat-{os.getuid()}-{root_tag}-*",
    )
    now = time.time()
    for path in glob.glob(pattern):
        if path == keep:
            continue
        try:
            st = os.lstat(path)
            if st.st_uid != os.getuid():
                continue
            # mtime of the mirror root moves on directory mutation only;
            # young mirror == a sibling may still be mid-creation of it
            if now - st.st_mtime < min_age_s:
                continue
            lock_path = os.path.join(path, _INUSE_NAME)
            fd = None
            try:
                fd = os.open(lock_path, os.O_RDONLY)
            except OSError:
                pass  # no lock file (pre-lock-version mirror): age decides
            if fd is not None:
                try:
                    fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                except OSError:
                    continue  # a live sibling holds it: in use, skip
                finally:
                    os.close(fd)
            shutil.rmtree(path, ignore_errors=True)
        except OSError:
            pass


_INUSE_NAME = ".inuse"
# fds of held mirror locks, keyed by mirror root; intentionally kept open
# for process lifetime so the pruner in sibling processes sees the mirror
# as in use (released by the kernel on exit/crash)
_mirror_lock_fds: dict = {}


def _hold_mirror_lock(shadow_root: str) -> None:
    """Take (and keep) a shared flock on the mirror's ``.inuse`` file so
    concurrent pruners never delete a mirror this process may still read
    MJCF from."""
    if shadow_root in _mirror_lock_fds:
        return
    import fcntl

    lock_path = os.path.join(shadow_root, _INUSE_NAME)
    try:
        fd = os.open(lock_path, os.O_CREAT | os.O_RDONLY, 0o600)
        fcntl.flock(fd, fcntl.LOCK_SH)
        _mirror_lock_fds[shadow_root] = fd
    except OSError:
        pass  # lock is best-effort; the age gate still applies


def _shadow_dir(src_dir: str) -> str:
    """Patched mirror of ``src_dir``: the whole assets tree is mirrored once
    (XMLs copied with apirate stripped, meshes/textures symlinked), and the
    corresponding shadow path for ``src_dir`` is returned. Idempotent, so a
    partial mirror left by a crashed process just gets finished."""
    cached = _shadow_dirs.get(src_dir)
    if cached is not None:
        return cached
    root = _assets_root(src_dir)
    # two-part tag: <root-path-hash>-<content-hash>. The content part makes
    # an in-place package upgrade mint a fresh mirror (existing entries are
    # trusted, so the tag must change whenever the sources do); the root
    # part scopes stale-mirror pruning to THIS assets tree, so concurrent
    # mirrors of other packages' trees are never touched.
    root_tag = hashlib.sha256(root.encode()).hexdigest()[:12]
    content_tag = hashlib.sha256(_tree_fingerprint(root)).hexdigest()[:12]
    tag = f"{root_tag}-{content_tag}"
    # Per-uid, mode-0700, ownership-verified: the path is predictable, so
    # on a multi-user host another user could otherwise pre-create it and
    # have MuJoCo load attacker-controlled MJCF (existing entries are
    # trusted and skipped below). Sharing WITHIN a uid is intentional —
    # --actor_procs workers reuse one mirror.
    shadow_root = os.path.join(
        tempfile.gettempdir(), f"d4pg-torch-mjcf-compat-{os.getuid()}-{tag}"
    )
    _prune_stale_mirrors(root_tag, keep=shadow_root)
    os.makedirs(shadow_root, mode=0o700, exist_ok=True)
    st = os.lstat(shadow_root)  # lstat: a planted symlink must not pass by
    # pointing at a directory the victim owns
    if st.st_uid != os.getuid() or not stat.S_ISDIR(st.st_mode):
        # someone else owns (or symlinked) the predictable path: fall back
        # to a private unshared mirror rather than trusting its contents
        shadow_root = tempfile.mkdtemp(prefix="d4pg-torch-mjcf-compat-")
    else:
        # mark the shared mirror in use for this process's lifetime so
        # sibling pruners (a later package upgrade mints a new tag) leave
        # it alone while we may still re-read its MJCF
        _hold_mirror_lock(shadow_root)
    for cur, dirs, files in os.walk(root):
        dst_cur = os.path.join(shadow_root, os.path.relpath(cur, root))
        os.makedirs(dst_cur, exist_ok=True)
        for name in files:
            src_path = os.path.join(cur, name)
            dst_path = os.path.join(dst_cur, name)
            if os.path.lexists(dst_path):
                # another process (--actor_procs spawns several, all
                # mirroring the same shared temp-dir tree at startup) already
                # materialized this entry; package assets are immutable,
                # so an existing file is always complete and current
                continue
            if name.endswith(".xml"):
                with open(src_path, "rb") as f:
                    data = _APIRATE.sub(b"", f.read())
                # write-then-rename so concurrent readers never observe a
                # truncated XML
                tmp_path = f"{dst_path}.{os.getpid()}.tmp"
                with open(tmp_path, "wb") as f:
                    f.write(data)
                os.replace(tmp_path, dst_path)
            else:
                try:
                    os.symlink(src_path, dst_path)
                except FileExistsError:
                    pass  # lost the race to a concurrent mirror — fine
    dst = os.path.normpath(
        os.path.join(shadow_root, os.path.relpath(src_dir, root))
    )
    _shadow_dirs[src_dir] = dst
    return dst


def install() -> None:
    """Idempotently hook ``MjModel.from_xml_path`` with the apirate shim."""
    global _installed
    if _installed:
        return
    import mujoco

    orig = mujoco.MjModel.from_xml_path

    def from_xml_path(xml_path, *args, **kwargs):
        src_dir = os.path.dirname(os.path.abspath(xml_path))
        if _needs_patch(src_dir):
            xml_path = os.path.join(
                _shadow_dir(src_dir), os.path.basename(xml_path)
            )
        return orig(xml_path, *args, **kwargs)

    mujoco.MjModel.from_xml_path = staticmethod(from_xml_path)
    _installed = True

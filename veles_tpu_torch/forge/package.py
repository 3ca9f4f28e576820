"""Forge package format: tar.gz + manifest.json.

The port's copy of ``veles_tpu/forge/package.py``; the bytes are the
JAX package's (a directory packed by either package gives the same
file), so each side reads, verifies and unpacks the other's packages.

Reference ``veles/forge_common.py:47`` + ``forge/forge_client.py:88-120``:
a model package is a gzipped tarball whose ``manifest.json`` declares
``name``, ``version``, ``workflow`` (the entry Python file), ``config``,
``short_description`` and a requirements-style ``requires`` list. Both
named files must exist in the archive.

Two additions for the AOT bundles (``aot/``):

- **deterministic bytes**: :func:`pack` stamps every tar member with a
  fixed epoch-0 mtime / zero uid-gid and writes the gzip wrapper with
  ``mtime=0`` — two packs of an identical directory are byte-identical,
  so sha-addressed stores dedupe instead of treating every repack as a
  new blob;
- **artifact members**: the manifest's optional ``artifacts`` list
  names AOT bundle members shipped inside the package, each with a
  ``<name>.sha256`` sidecar member (the snapshotter's shasum format).
  :func:`verify_artifact_members` re-hashes them — the forge server
  runs it on every upload and rejects tampered packages with 422
  instead of storing them.
"""

import gzip
import hashlib
import io
import json
import os
import re
import tarfile

MANIFEST = "manifest.json"
_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]*$")


class TamperedPackageError(ValueError):
    """An artifact member's bytes do not match its sha256 sidecar."""


def validate_manifest(manifest):
    if not isinstance(manifest, dict):
        raise TypeError("manifest must be a JSON object")
    for field in ("name", "workflow"):
        if not manifest.get(field):
            raise ValueError("manifest is missing %r" % field)
    if not _NAME_RE.match(manifest["name"]):
        raise ValueError("invalid package name %r" % manifest["name"])
    version = manifest.get("version")
    if version is not None and not _NAME_RE.match(str(version)):
        # the version becomes a server filesystem component, an SLO
        # label value and a rollout/incident identity — fail at pack
        # time, not at upload (server) or deploy (serving) time
        raise ValueError("invalid package version %r" % version)
    requires = manifest.get("requires", [])
    if not isinstance(requires, list) \
            or not all(isinstance(r, str) for r in requires):
        raise TypeError("'requires' must be a list of requirement strings")
    artifacts = manifest.get("artifacts", [])
    if not isinstance(artifacts, list) \
            or not all(isinstance(a, str) and a for a in artifacts):
        raise TypeError("'artifacts' must be a list of member names")
    seen = set()
    for item in requires:
        project = re.split(r"[<>=!~\[; ]", item, 1)[0].strip()
        if project in seen:
            raise ValueError("%r listed in 'requires' twice" % project)
        seen.add(project)
    return manifest


def deploy_version(manifest):
    """The canonical deploy identity of a package: ``name@version``
    (version defaulting to the server's ``1.0``). This is the string
    zero-downtime deploys stamp everywhere one rollout must be
    traceable end to end — ``GenerateAPI.begin_rollout(version=...)``,
    the SLO engine's per-version burn slices, the rollback incident
    artifact and the ledger's governor actuations all carry it, so an
    operator can join "which package" to "which incident" without a
    side channel."""
    validate_manifest(manifest)
    return "%s@%s" % (manifest["name"],
                      str(manifest.get("version") or "1.0"))


def pack(directory, out_path=None):
    """Pack ``directory`` (which must contain manifest.json) into a
    tar.gz; returns (path, manifest)."""
    manifest_path = os.path.join(directory, MANIFEST)
    with open(manifest_path) as fin:
        manifest = validate_manifest(json.load(fin))
    for field in ("workflow", "config"):
        name = manifest.get(field)
        if name and not os.path.isfile(os.path.join(directory, name)):
            raise FileNotFoundError(
                "manifest names %s=%r but the file is absent"
                % (field, name))
    for name in manifest.get("artifacts", []):
        for member in (name, name + ".sha256"):
            if not os.path.isfile(os.path.join(directory, member)):
                raise FileNotFoundError(
                    "manifest lists artifact %r but %s is absent"
                    % (name, member))
    if out_path is None:
        out_path = os.path.join(
            directory, "%s.tar.gz" % manifest["name"])

    def deterministic(info):
        # fixed mtime / zero ownership / normalized modes: two packs
        # of identical state must hash identically ACROSS machines
        # (the sha-addressed dedup contract) — mode bits would
        # otherwise carry the packing user's umask
        info.mtime = 0
        info.uid = info.gid = 0
        info.uname = info.gname = ""
        if info.isdir() or info.mode & 0o100:
            info.mode = 0o755
        else:
            info.mode = 0o644
        return info

    # gzip via an explicit wrapper: tarfile's "w:gz" stamps the gzip
    # header with time.time(), which alone made every repack a new sha
    with open(out_path, "wb") as raw, \
            gzip.GzipFile(filename="", mode="wb", fileobj=raw,
                          mtime=0) as gz, \
            tarfile.open(fileobj=gz, mode="w") as tar:
        for entry in sorted(os.listdir(directory)):
            full = os.path.join(directory, entry)
            if os.path.abspath(full) == os.path.abspath(out_path):
                continue
            tar.add(full, arcname=entry, filter=deterministic)
    return out_path, manifest


def read_manifest(blob):
    """Extract + validate the manifest from package bytes."""
    try:
        with tarfile.open(fileobj=io.BytesIO(blob), mode="r:gz") as tar:
            try:
                member = tar.getmember(MANIFEST)
            except KeyError:
                raise ValueError("package has no %s" % MANIFEST)
            manifest = json.load(tar.extractfile(member))
    except tarfile.TarError as exc:
        raise ValueError("not a valid package archive: %s" % exc)
    return validate_manifest(manifest)


def verify_artifact_members(blob, manifest=None, inventory=None):
    """Check every AOT artifact member the manifest lists against its
    ``.sha256`` sidecar member (the snapshotter's shasum format: any
    listed digest vouches, comment lines ignored — the same convention
    ``SnapshotterToFile._load_verified`` reads). Raises
    :class:`TamperedPackageError` naming the bad member; the forge
    server maps that to 422 on upload, so a bundle corrupted in
    transit (or maliciously swapped) is never stored.

    ``inventory`` (:func:`file_inventory`'s output) supplies the
    members' already-computed digests so the (large) artifact bytes
    are not decompressed and hashed a second time on the upload path —
    only the tiny sidecar members are extracted here."""
    if manifest is None:
        manifest = read_manifest(blob)
    artifacts = manifest.get("artifacts", [])
    if not artifacts:
        return manifest
    with tarfile.open(fileobj=io.BytesIO(blob), mode="r:gz") as tar:
        for name in artifacts:
            if inventory is not None and name in inventory:
                got = inventory[name]["sha256"]
            else:
                try:
                    got = hashlib.sha256(tar.extractfile(
                        tar.getmember(name)).read()).hexdigest()
                except KeyError:
                    raise TamperedPackageError(
                        "manifest lists artifact %r but the member is "
                        "missing" % name)
            try:
                sidecar = tar.extractfile(
                    tar.getmember(name + ".sha256")).read().decode()
            except KeyError:
                raise TamperedPackageError(
                    "artifact %r has no .sha256 sidecar member" % name)
            want = [line.split()[0] for line in sidecar.splitlines()
                    if line.strip() and not line.startswith("#")]
            if not want or got not in want:
                raise TamperedPackageError(
                    "artifact %r sha256 %s not among its sidecar "
                    "digests %s — refusing the tampered package"
                    % (name, got, want))
    return manifest


def file_inventory(blob):
    """Per-file metadata of a package: {name: {"size", "sha256"}} —
    the diffable content record the server stores with every version
    (the role of the reference's per-model git history)."""
    out = {}
    with tarfile.open(fileobj=io.BytesIO(blob), mode="r:gz") as tar:
        for member in tar.getmembers():
            if not member.isfile():
                continue
            digest = hashlib.sha256(
                tar.extractfile(member).read()).hexdigest()
            out[member.name] = {"size": member.size, "sha256": digest}
    return out


def unpack(blob, dest):
    """Safely extract package bytes into ``dest``; returns the manifest."""
    os.makedirs(dest, exist_ok=True)
    manifest = read_manifest(blob)
    with tarfile.open(fileobj=io.BytesIO(blob), mode="r:gz") as tar:
        for member in tar.getmembers():
            # no absolute paths / traversal out of dest
            target = os.path.realpath(os.path.join(dest, member.name))
            if not target.startswith(os.path.realpath(dest) + os.sep):
                raise ValueError("unsafe member path %r" % member.name)
            if not (member.isfile() or member.isdir()):
                continue  # no links/devices from untrusted archives
            tar.extract(member, dest, set_attrs=False, filter="data")
    return manifest

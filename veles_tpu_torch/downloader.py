"""Downloader: fetch and unpack dataset archives at initialize time.

The port of ``veles_tpu/downloader.py`` (reference ``veles/downloader.py:
56``): a unit that, before anything else runs, makes sure the archive
named by ``url`` is present in ``directory`` and unpacked. It is a no-op
when the expected files exist already. :func:`fetch` takes plain files,
``.gz`` single members, ``.tar[.gz|.bz2|.xz]`` and ``.zip`` archives, from
``http(s)://`` and ``file://`` URLs and local paths, with an optional
sha256 check; a ``<name>.ok`` marker after a whole fetch, check and unpack
makes later calls return at once. Nothing here touches the card.

Unlike the JAX package, a :class:`Downloader` without a ``directory``
takes ``root.common.dirs.datasets`` only where that is configured, and
raises otherwise: the port writes nothing outside its checkout unless it
is told where.
"""

import gzip
import hashlib
import os
import shutil
import tarfile
import urllib.parse
import urllib.request
import zipfile

from veles_tpu_torch.core.config import root
from veles_tpu_torch.core.units import Unit


def fetch(url, directory, checksum=None, logger=None):
    """Download ``url`` into ``directory`` and unpack it; returns the
    extracted paths (or the downloaded file itself). After a successful
    fetch, check and unpack a ``<name>.ok`` marker is written, and later
    calls return on it without hashing or extracting again."""
    os.makedirs(directory, exist_ok=True)
    name = os.path.basename(urllib.parse.urlparse(url).path) \
        or "download.bin"
    target = os.path.join(directory, name)
    marker = target + ".ok"
    if os.path.exists(marker) and os.path.exists(target):
        return [target]
    if not os.path.exists(target):
        if logger is not None:
            logger.info("fetching %s", url)
        if "://" not in url:
            shutil.copy(url, target)
        else:
            tmp = target + ".part"
            with urllib.request.urlopen(url) as response, \
                    open(tmp, "wb") as out:
                shutil.copyfileobj(response, out)
            os.replace(tmp, target)
    if checksum is not None:
        sha = hashlib.sha256()
        with open(target, "rb") as fin:
            for chunk in iter(lambda: fin.read(1 << 20), b""):
                sha.update(chunk)
        if sha.hexdigest() != checksum:
            os.remove(target)
            raise ValueError("%s: sha256 mismatch (got %s, want %s)"
                             % (url, sha.hexdigest(), checksum))
    members = unpack(target, directory)
    with open(marker, "w") as out:
        out.write("ok\n")
    return members


def unpack(path, directory):
    """Unpack an archive in place; returns the extracted members' paths."""
    if tarfile.is_tarfile(path):
        with tarfile.open(path) as tar:
            tar.extractall(directory, filter="data")
            return [os.path.join(directory, m) for m in tar.getnames()]
    if zipfile.is_zipfile(path):
        with zipfile.ZipFile(path) as zf:
            zf.extractall(directory)
            return [os.path.join(directory, m) for m in zf.namelist()]
    if path.endswith(".gz"):
        member = path[:-3]
        if not os.path.exists(member):
            # through a temporary name and an atomic rename: an interrupted
            # extraction leaves no truncated member for a later run to
            # take for the real file
            tmp = member + ".part"
            with gzip.open(path, "rb") as fin, open(tmp, "wb") as out:
                shutil.copyfileobj(fin, out)
            os.replace(tmp, member)
        return [member]
    return [path]


class Downloader(Unit):
    """The dataset-fetching unit (reference ``downloader.py:56``).

    kwargs: ``url`` (or a ``urls`` list), ``directory`` (default:
    ``root.common.dirs.datasets``, which must then be set), ``files``:
    names that must exist afterwards (also the early-return check), and
    ``checksums``: url -> sha256."""

    VIEW_GROUP = "SERVICE"

    def __init__(self, workflow, **kwargs):
        self.urls = list(kwargs.pop("urls", ()))
        url = kwargs.pop("url", None)
        if url:
            self.urls.append(url)
        self.directory = kwargs.pop(
            "directory", root.common.dirs.get("datasets", None))
        if self.directory is None:
            raise ValueError("Downloader needs a directory (directory= or "
                             "root.common.dirs.datasets)")
        self.files = list(kwargs.pop("files", ()))
        self.checksums = dict(kwargs.pop("checksums", {}))
        super().__init__(workflow, **kwargs)

    def _missing(self):
        return [f for f in self.files
                if not os.path.exists(os.path.join(self.directory, f))]

    def initialize(self, **kwargs):
        if self.files and not self._missing():
            self.debug("all %d files already present in %s",
                       len(self.files), self.directory)
            return
        for url in self.urls:
            fetch(url, self.directory, self.checksums.get(url), self)
        missing = self._missing()
        if missing:
            raise FileNotFoundError(
                "%s: still missing after download: %s"
                % (self.name, ", ".join(missing)))

    def run(self):
        pass

"""File-scanning loader bases.

The port of ``veles_tpu/loader/file_loader.py`` (reference
``veles/loader/file_loader.py:48-277``), plain Python, as there. The
reference made these Unit subclasses combined into loaders by multiple
inheritance; here they are plain **mixins** layered onto a Loader (which
already provides logging), so there is no Unit diamond and the scanning
logic stays importable without a workflow.

- :class:`FileFilter` — include/ignore regexp lists + MIME filtering by
  ``file_type``/``file_subtypes`` (reference ``file_loader.py:54-148``);
- :class:`FileListScannerMixin` — sample lists from index files, either
  ``path label`` text lines or a JSON map (reference ``:150-203``);
- :class:`FileScannerMixin` — recursive directory walks over
  ``test_paths``/``validation_paths``/``train_paths`` (reference
  ``:205-264``);
- :class:`AutoLabelMixin` — labels extracted from file paths by regexp,
  defaulting to the parent directory name (reference ``:267-277``).
"""

import json
import os
import re
from mimetypes import guess_type


class FileFilter:
    """Filename filter: whitelist/blacklist regexps + MIME type match
    (reference ``file_loader.py:54-148``)."""

    def __init__(self, **kwargs):
        self.ignored_files = list(kwargs.pop("ignored_files", []))
        self.included_files = list(kwargs.pop("included_files", [".*"]))
        self.file_type = kwargs.pop("file_type")
        self.file_subtypes = list(kwargs.pop("file_subtypes"))
        # (?:...) groups the alternatives so EVERY pattern is both start-
        # and end-anchored, not just the first/last
        self._blacklist_re = re.compile(
            "^(?:%s)$" % "|".join(self.ignored_files)) \
            if self.ignored_files else None
        self._whitelist_re = re.compile(
            "^(?:%s)$" % "|".join(self.included_files))
        self._mime_re = re.compile(self.mime)

    @property
    def mime(self):
        return "%s/(%s)" % (self.file_type, "|".join(self.file_subtypes))

    def is_valid_filename(self, filename):
        if self._blacklist_re is not None \
                and self._blacklist_re.match(filename):
            return False
        if not self._whitelist_re.match(filename):
            return False
        mime = guess_type(filename)[0]
        if mime is None:
            return False
        return self._mime_re.match(mime) is not None


class FileScannerMixin:
    """Recursive directory scanning of per-class path lists (reference
    ``FileLoaderBase``, ``file_loader.py:205-264``). The host class must
    provide :meth:`is_valid_filename` (e.g. via :class:`FileFilter`) and
    ``info``/``warning`` logging (via Unit)."""

    def __init__(self, **kwargs):
        self.test_paths = self._check_paths(kwargs.pop("test_paths", []))
        self.validation_paths = self._check_paths(
            kwargs.pop("validation_paths", []))
        self.train_paths = self._check_paths(kwargs.pop("train_paths", []))

    @staticmethod
    def _check_paths(paths):
        if isinstance(paths, str) or not hasattr(paths, "__iter__"):
            raise TypeError("paths must be a list or tuple of directories")
        return list(paths)

    def scan_files(self, pathname):
        self.info("scanning %s...", pathname)
        files = []
        for basedir, dirs, filelist in os.walk(pathname):
            # deterministic traversal: os.walk's directory order is
            # filesystem-dependent; reproducible sample order (and MSE
            # sample<->target pairing) needs a stable scan
            dirs.sort()
            for name in sorted(filelist):
                full_name = os.path.join(basedir, name)
                if self.is_valid_filename(full_name):
                    files.append(full_name)
        if not files:
            self.warning("no files were taken from %s", pathname)
        return files

    def get_label_from_filename(self, filename):
        """Abstract: map a file path to its label."""
        raise NotImplementedError

    def collect_keys(self, paths):
        keys = []
        for path in paths:
            keys.extend(self.scan_files(path))
        return keys


class FileListScannerMixin:
    """Sample lists read from index files: ``path[ label]`` text lines or
    a JSON ``{name: {"path": ..., "label": [...]}}`` map (reference
    ``FileListLoaderBase``, ``file_loader.py:150-203``)."""

    def __init__(self, **kwargs):
        self.path_to_test_text_file = kwargs.pop(
            "path_to_test_text_file", "")
        self.path_to_val_text_file = kwargs.pop("path_to_val_text_file", "")
        self.path_to_train_text_file = kwargs.pop(
            "path_to_train_text_file", "")
        self.base_directory = kwargs.pop("base_directory", None)
        self._file_labels = {}

    def _abs_path(self, path):
        path = path.strip()
        if self.base_directory is not None:
            return os.path.join(self.base_directory, path)
        return path

    def scan_files(self, pathname):
        self.info("scanning %s...", pathname)
        files = []
        if pathname.endswith(".json"):
            with open(pathname, "r") as fin:
                for image in json.load(fin).values():
                    if image.get("label"):
                        path = self._abs_path(image["path"])
                        self._file_labels[path] = image["label"][0]
                        files.append(path)
        else:
            with open(pathname, "r") as fin:
                for line in fin:
                    if not line.strip():
                        continue
                    path, _, label = line.strip().partition(" ")
                    path = self._abs_path(path)
                    if label:
                        self._file_labels[path] = label
                    files.append(path)
        if not files:
            self.warning("no files were taken from %s", pathname)
        return files

    def get_label_from_filename(self, filename):
        return self._file_labels.get(filename)


class AutoLabelMixin:
    """Label = regexp group over the file path; the default pattern takes
    the parent directory name (reference ``AutoLabelFileLoader``,
    ``file_loader.py:267-277``)."""

    DEFAULT_LABEL_REGEXP = ".*%(sep)s([^%(sep)s]+)%(sep)s[^%(sep)s]+$" % {
        "sep": "\\" + os.sep}

    def __init__(self, **kwargs):
        self.label_regexp = re.compile(
            kwargs.pop("label_regexp", self.DEFAULT_LABEL_REGEXP))

    def get_label_from_filename(self, filename):
        match = self.label_regexp.search(filename)
        if match is None:
            raise ValueError("%s does not match label regexp %s"
                             % (filename, self.label_regexp.pattern))
        return match.group(1)

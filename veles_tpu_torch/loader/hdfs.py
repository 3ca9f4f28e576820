"""HDFS text streaming loader (reference ``loader/hdfs_loader.py:48-77``).

The port of ``veles_tpu/loader/hdfs.py``. It speaks WebHDFS, the REST
API every Hadoop namenode serves, through ``urllib`` alone (the reference
used snakebite's native protocol):

- ``HDFSTextLoader(wf, file="/path", address="namenode:9870",
  chunk=1000)`` streams the file as text lines;
- each ``run()`` fills ``output`` (a list of ``chunk`` lines) with the
  next chunk and raises the ``finished`` Bool at the end of the file,
  with ``output`` cut to the lines it holds;
- ``initialize()`` stats the file first (existence and permissions).

A namenode may redirect OPEN to a datanode, which ``urllib`` follows.
``lines_consumed`` pickles with the unit, so a resumed workflow skips the
lines it served. The loader is host-side text: nothing here touches the
card.
"""

import json
import urllib.parse
import urllib.request

from veles_tpu_torch.core.mutable import Bool
from veles_tpu_torch.core.units import Unit


class HDFSTextLoader(Unit):
    """Streams a text file from HDFS in line chunks of a fixed size."""

    def __init__(self, workflow, **kwargs):
        self.file_name = kwargs.pop("file")
        self.chunk_lines_number = kwargs.pop("chunk", 1000)
        address = kwargs.pop("address", "localhost:9870")
        self.user = kwargs.pop("user", None)
        self.encoding = kwargs.pop("encoding", "utf-8")
        #: a hung namenode or datanode must not block the workflow
        self.timeout = kwargs.pop("timeout", 60.0)
        super().__init__(workflow, **kwargs)
        #: lines served so far (pickled: a resume skips them)
        self.lines_consumed = 0
        self.base_url = ("http://%s/webhdfs/v1" % address
                         if "://" not in address
                         else address.rstrip("/") + "/webhdfs/v1")
        self.output = [""] * self.chunk_lines_number
        self.finished = Bool(False)

    def _url(self, op):
        query = {"op": op}
        if self.user:
            query["user.name"] = self.user
        return "%s%s?%s" % (self.base_url,
                            urllib.parse.quote(self.file_name),
                            urllib.parse.urlencode(query))

    def stat(self):
        """GETFILESTATUS: the file's size, type and permissions."""
        with urllib.request.urlopen(self._url("GETFILESTATUS"),
                                    timeout=self.timeout) as resp:
            return json.loads(resp.read().decode("utf-8"))["FileStatus"]

    def initialize(self, **kwargs):
        status = self.stat()
        self.debug("opened %s (%d bytes)", self.file_name,
                   status.get("length", -1))
        self._response_ = urllib.request.urlopen(self._url("OPEN"),
                                                 timeout=self.timeout)
        self._generator_ = (line.rstrip("\n") for line in
                            (raw.decode(self.encoding)
                             for raw in self._response_))
        for _ in range(self.lines_consumed):
            # the lines a restored snapshot served already
            next(self._generator_, None)

    def init_unpickled(self):
        super().init_unpickled()
        self._response_ = None
        self._generator_ = None

    def run(self):
        assert not self.finished
        filled = 0
        try:
            for i in range(self.chunk_lines_number):
                self.output[i] = next(self._generator_)
                filled += 1
                self.lines_consumed += 1
        except StopIteration:
            # the previous chunk's stale tail is not data
            del self.output[filled:]
            self.finished.set()
            self._response_.close()

"""Forge client: fetch/upload/list/details/delete against a forge server.

The port's copy of ``veles_tpu/forge/client.py``, reference
``veles/forge/forge_client.py:88-430``. CLI surface preserved:
``python -m veles_tpu_torch forge <action> [-s SERVER] ...`` with actions
``list``, ``details -n NAME``, ``fetch -n NAME [-v VERSION] [-d DIR]``,
``upload -d DIR [-v VERSION]``, ``delete -n NAME [-v VERSION]``,
``history -n NAME``, ``diff -n NAME --from V1 --to V2`` and
``register --email ADDRESS``.
Write actions send the shared token (``-t`` /
``VELES_TPU_FORGE_TOKEN``)."""

import argparse
import json
import os
import urllib.parse
import urllib.request

from veles_tpu_torch.core.config import root
from veles_tpu_torch.core.logger import Logger
from veles_tpu_torch.forge import package as pkg


class ForgeClient(Logger):
    def __init__(self, base_url=None, token=None):
        super().__init__()
        self.base_url = (base_url
                         or root.common.forge.get("server",
                                                  "http://127.0.0.1:8190")
                         ).rstrip("/")
        self.token = token or os.environ.get("VELES_TPU_FORGE_TOKEN")

    def _request(self, path, query=None, data=None):
        url = self.base_url + path
        if query:
            url += "?" + urllib.parse.urlencode(query)
        headers = {}
        if data is not None:
            headers["Content-Type"] = "application/octet-stream"
            if self.token:
                headers["X-Forge-Token"] = self.token
        req = urllib.request.Request(url, data=data, headers=headers)
        with urllib.request.urlopen(req, timeout=60) as resp:
            body = resp.read()
        if resp.headers.get("Content-Type", "").startswith(
                "application/json"):
            return json.loads(body.decode())
        return body

    # -- actions (reference forge_client.py subcommands) ----------------------
    def list(self):
        return self._request("/service", {"query": "list"})

    def details(self, name):
        return self._request("/service", {"query": "details",
                                          "name": name})

    def fetch_blob(self, name, version=None):
        """The package's bytes as the store holds them (``version``
        None: the latest), unverified and not unpacked."""
        query = {"name": name}
        if version:
            query["version"] = version
        return self._request("/fetch", query)

    def fetch(self, name, version=None, dest=None):
        blob = self.fetch_blob(name, version)
        dest = dest or name
        manifest = pkg.unpack(blob, dest)
        self.info("fetched %s %s into %s", name,
                  version or "(latest)", dest)
        return dest, manifest

    def upload(self, directory, version=None):
        path, manifest = pkg.pack(directory)
        try:
            with open(path, "rb") as fin:
                blob = fin.read()
            query = {}
            if version or manifest.get("version"):
                query["version"] = version or manifest["version"]
            result = self._request("/upload", query, data=blob)
        finally:
            os.unlink(path)
        self.info("uploaded %s version %s", result["name"],
                  result["version"])
        return result

    def delete(self, name, version=None):
        query = {"name": name}
        if version:
            query["version"] = version
        return self._request("/delete", query, data=b"")

    def history(self, name):
        """Chronological version timeline of a model."""
        return self._request("/service", {"query": "history",
                                          "name": name})

    def diff(self, name, v_from, v_to):
        """Manifest + file changes between two stored versions."""
        return self._request("/service", {"query": "diff", "name": name,
                                          "from": v_from, "to": v_to})

    def register(self, email):
        """Request an upload token for ``email``."""
        req = urllib.request.Request(
            self.base_url + "/register",
            data=json.dumps({"email": email}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            return json.loads(resp.read().decode())


def main(argv=None):
    """``veles_tpu_torch forge`` subcommand entry (reference
    ``__main__.py:230-241`` wiring)."""
    parser = argparse.ArgumentParser(prog="veles_tpu_torch forge")
    parser.add_argument("action", choices=("list", "details", "fetch",
                                           "upload", "delete",
                                           "history", "diff",
                                           "register"))
    parser.add_argument("-s", "--server", default=None,
                        help="forge server base URL")
    parser.add_argument("-n", "--name", default=None)
    parser.add_argument("-v", "--version", default=None)
    parser.add_argument("-d", "--directory", default=None,
                        help="fetch destination / upload source")
    parser.add_argument("-t", "--token", default=None)
    parser.add_argument("--from", dest="v_from", default=None,
                        help="diff base version")
    parser.add_argument("--to", dest="v_to", default=None,
                        help="diff target version")
    parser.add_argument("--email", default=None,
                        help="register: the uploader email")
    args = parser.parse_args(argv)
    client = ForgeClient(args.server, args.token)
    if args.action == "list":
        print(json.dumps(client.list(), indent=1))
    elif args.action == "details":
        if not args.name:
            parser.error("details needs -n NAME")
        print(json.dumps(client.details(args.name), indent=1))
    elif args.action == "fetch":
        if not args.name:
            parser.error("fetch needs -n NAME")
        dest, manifest = client.fetch(args.name, args.version,
                                      args.directory)
        print(json.dumps({"directory": dest, "manifest": manifest},
                         indent=1))
    elif args.action == "upload":
        if not args.directory:
            parser.error("upload needs -d DIRECTORY")
        print(json.dumps(client.upload(args.directory, args.version),
                         indent=1))
    elif args.action == "delete":
        if not args.name:
            parser.error("delete needs -n NAME")
        print(json.dumps(client.delete(args.name, args.version),
                         indent=1))
    elif args.action == "history":
        if not args.name:
            parser.error("history needs -n NAME")
        print(json.dumps(client.history(args.name), indent=1))
    elif args.action == "diff":
        if not (args.name and args.v_from and args.v_to):
            parser.error("diff needs -n NAME --from V1 --to V2")
        print(json.dumps(client.diff(args.name, args.v_from,
                                     args.v_to), indent=1))
    elif args.action == "register":
        if not args.email:
            parser.error("register needs --email ADDRESS")
        print(json.dumps(client.register(args.email), indent=1))
    return 0

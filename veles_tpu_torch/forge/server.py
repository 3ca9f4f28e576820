"""Forge server: the model-hub backend.

The port's copy of ``veles_tpu/forge/server.py`` on the port's
``core/httpd.py``; the on-disk store is the JAX package's, so a store
that one package's server wrote is served by the other's. A re-design of
reference ``veles/forge/forge_server.py:103-440``.
The reference kept one git repository per model (tags as versions) behind
Tornado with an HTML gallery and e-mail registration; here the store is a
plain versioned directory tree behind the shared stdlib HTTP plumbing —
the same API surface (list / details / fetch / upload / delete) plus the
git history's two jobs re-designed in:

- every stored version carries a **diffable content record** (the
  manifest + a per-file size/sha256 inventory), so ``history`` walks
  the version timeline and ``diff`` answers "what changed between V1
  and V2" the way ``git diff`` between the reference's tags did;
- **registration** issues per-uploader tokens (``POST /register`` with
  an email; the reference mailed a confirmation — with no mailer in
  this environment the token returns in the response for the operator
  to hand over) and each version records who uploaded it.

Store layout::

    <root>/<model>/<version>.tar.gz
    <root>/<model>/meta.json   {"versions": {...}, "latest": "..."}
    <root>/tokens.json         {"tokens": {token: {"email", "issued"}}}

Endpoints (reference ``forge_server.py`` handlers):

- ``GET /service?query=list`` — all models (name, latest, description);
- ``GET /service?query=details&name=N`` — full metadata;
- ``GET /service?query=history&name=N`` — chronological version list;
- ``GET /service?query=diff&name=N&from=V1&to=V2`` — manifest + file
  changes between two versions;
- ``GET /fetch?name=N[&version=V]`` — package bytes;
- ``POST /register`` — ``{"email": ...}`` -> ``{"token": ...}``;
- ``POST /upload?version=V`` — package bytes (manifest inside names the
  model); requires the master token or a registered one when a master
  token is set;
- ``POST /delete?name=N[&version=V]`` — remove; MASTER token required
  (registered tokens may only upload — open registration must not be
  an anonymous path to deleting other people's models).
"""

import json
import os
import re
import secrets
import threading
import time
import urllib.parse

from veles_tpu_torch.core.logger import Logger
from veles_tpu_torch.forge import package as pkg

#: upload body cap: model packages (weight archives) dwarf the shared
#: httpd JSON cap; bounded all the same so no client can exhaust RAM
UPLOAD_MAX_BODY = 4 << 30

_EMAIL_RE = re.compile(r"^[^@\s]+@[^@\s]+\.[^@\s]+$")


class ForgeServer(Logger):
    def __init__(self, root_dir, port=0, host="127.0.0.1", token=None):
        super().__init__()
        self.root_dir = root_dir
        self.port = port
        self.host = host
        self.token = token
        self._lock = threading.Lock()
        self._httpd = None
        os.makedirs(root_dir, exist_ok=True)

    # -- store ----------------------------------------------------------------
    def _meta_path(self, name):
        return os.path.join(self.root_dir, name, "meta.json")

    def _load_meta(self, name):
        try:
            with open(self._meta_path(name)) as fin:
                return json.load(fin)
        except OSError:
            return None

    def _store_meta(self, name, meta):
        with open(self._meta_path(name), "w") as fout:
            json.dump(meta, fout, indent=1)

    def list_models(self):
        with self._lock:
            out = []
            for name in sorted(os.listdir(self.root_dir)):
                meta = self._load_meta(name)
                if meta:
                    out.append({
                        "name": name, "latest": meta.get("latest"),
                        "short_description": meta.get("versions", {}).get(
                            meta.get("latest"), {}).get(
                            "short_description", "")})
            return out

    def details(self, name):
        with self._lock:
            return self._load_meta(name)

    def history(self, name):
        """Chronological version timeline (the reference's git log over
        a model repo, ``forge_server.py:103-440``)."""
        with self._lock:
            meta = self._load_meta(name)
            if not meta:
                return None
            rows = []
            for version, entry in meta.get("versions", {}).items():
                rows.append({
                    "version": version,
                    "uploaded": entry.get("uploaded"),
                    "uploaded_by": entry.get("uploaded_by"),
                    "size": entry.get("size"),
                    "short_description": entry.get(
                        "short_description", "")})
            rows.sort(key=lambda r: (r["uploaded"] or 0, r["version"]))
            return {"name": name, "latest": meta.get("latest"),
                    "history": rows}

    def diff(self, name, v_from, v_to):
        """What changed between two stored versions: manifest keys and
        package files (added / removed / changed-by-content) — the
        ``git diff tag1 tag2`` answer from the version records."""
        with self._lock:
            meta = self._load_meta(name)
            if not meta:
                return None
            versions = meta.get("versions", {})
            if v_from not in versions or v_to not in versions:
                return None
            out = {"name": name, "from": v_from, "to": v_to}
            for key, a, b in (
                    ("manifest",
                     {k: v for k, v in versions[v_from].items()
                      if k not in ("files", "uploaded", "size",
                                   "uploaded_by")},
                     {k: v for k, v in versions[v_to].items()
                      if k not in ("files", "uploaded", "size",
                                   "uploaded_by")}),
                    ("files", versions[v_from].get("files", {}),
                     versions[v_to].get("files", {}))):
                out[key] = {
                    "added": sorted(set(b) - set(a)),
                    "removed": sorted(set(a) - set(b)),
                    "changed": sorted(k for k in set(a) & set(b)
                                      if a[k] != b[k])}
            return out

    # -- registration ---------------------------------------------------------
    def _tokens_path(self):
        return os.path.join(self.root_dir, "tokens.json")

    def _load_tokens(self):
        # ValueError too: a truncated/corrupt token store must degrade
        # to "no registered tokens", never 500 every write forever
        try:
            with open(self._tokens_path()) as fin:
                return json.load(fin)
        except (OSError, ValueError):
            return {"tokens": {}}

    def register(self, email):
        """Issue an upload token for ``email`` (reference registration
        flow, sans mailer: the token rides the response)."""
        if not isinstance(email, str) or not _EMAIL_RE.match(email):
            raise ValueError("invalid email address")
        with self._lock:
            store = self._load_tokens()
            token = secrets.token_hex(16)
            store["tokens"][token] = {"email": email,
                                      "issued": time.time()}
            # atomic replace: _authorized reads without the lock from
            # handler threads — they must never see a half-written file
            tmp = self._tokens_path() + ".tmp"
            with open(tmp, "w") as fout:
                json.dump(store, fout, indent=1)
            os.replace(tmp, self._tokens_path())
        self.info("registered %s", email)
        return {"email": email, "token": token}

    @staticmethod
    def _safe_version(version):
        if not pkg._NAME_RE.match(version):
            raise ValueError("invalid version %r" % version)
        return version

    def upload(self, blob, version=None, uploaded_by=None):
        manifest = pkg.read_manifest(blob)
        name = manifest["name"]
        version = self._safe_version(
            str(version or manifest.get("version", "1.0")))
        files = pkg.file_inventory(blob)
        # AOT artifact members are verified against their sha256
        # sidecars ON RECEIPT: a bundle corrupted in transit (or
        # swapped for one that would execute different programs) is
        # refused with 422 — never stored, never served to a replica.
        # The inventory above already hashed every member, so this
        # pass only reads the tiny sidecar texts.
        pkg.verify_artifact_members(blob, manifest, inventory=files)
        with self._lock:
            model_dir = os.path.join(self.root_dir, name)
            os.makedirs(model_dir, exist_ok=True)
            meta = self._load_meta(name) or {"versions": {}}
            # ownership: the first uploader owns the model name; later
            # versions need the same identity or the master token —
            # open registration must not allow hijacking another
            # uploader's "latest" (every default fetch would run it)
            owner = meta.get("owner")
            if owner is None and meta["versions"]:
                # pre-ownership store: seed from the recorded uploader
                # history instead of first-come-first-claimed
                rows = sorted(meta["versions"].values(),
                              key=lambda e: e.get("uploaded", 0))
                owner = next((e.get("uploaded_by") for e in rows
                              if e.get("uploaded_by")), None)
            if owner is None:
                meta["owner"] = uploaded_by or "anonymous"
            elif uploaded_by not in (owner, "master"):
                raise PermissionError(
                    "%s is owned by %s; only the owner or the master "
                    "token may add versions" % (name, owner))
            else:
                meta["owner"] = owner
            if version in meta["versions"]:
                raise ValueError("%s version %s already exists"
                                 % (name, version))
            with open(os.path.join(model_dir, version + ".tar.gz"),
                      "wb") as fout:
                fout.write(blob)
            entry = dict(manifest)
            entry["uploaded"] = time.time()
            entry["size"] = len(blob)
            entry["files"] = files
            if uploaded_by:
                entry["uploaded_by"] = uploaded_by
            meta["versions"][version] = entry
            meta["latest"] = version
            self._store_meta(name, meta)
        self.info("stored %s version %s (%d bytes)", name, version,
                  len(blob))
        return {"name": name, "version": version}

    def fetch(self, name, version=None):
        with self._lock:
            meta = self._load_meta(name)
            if not meta:
                return None
            version = str(version or meta.get("latest"))
            if not pkg._NAME_RE.match(version):
                return None
            path = os.path.join(self.root_dir, name, version + ".tar.gz")
            if not os.path.isfile(path):
                return None
            with open(path, "rb") as fin:
                return fin.read()

    def delete(self, name, version=None):
        with self._lock:
            meta = self._load_meta(name)
            if not meta:
                return False
            if version is None:
                versions = list(meta["versions"])
            else:
                version = str(version)
                if not pkg._NAME_RE.match(version):
                    return False
                versions = [version]
            for v in versions:
                meta["versions"].pop(v, None)
                try:
                    os.unlink(os.path.join(self.root_dir, name,
                                           v + ".tar.gz"))
                except OSError:
                    pass
            if meta["versions"]:
                meta["latest"] = sorted(meta["versions"])[-1]
                self._store_meta(name, meta)
            else:
                for leftover in (self._meta_path(name),):
                    try:
                        os.unlink(leftover)
                    except OSError:
                        pass
                try:
                    os.rmdir(os.path.join(self.root_dir, name))
                except OSError:
                    pass
            return True

    # -- HTTP -----------------------------------------------------------------
    @staticmethod
    def _safe_name(name):
        return bool(name) and pkg._NAME_RE.match(name) is not None

    def _authorized(self, handler):
        """Returns the writer's identity ("master", a registered email,
        or "anonymous" on an open server) or None when unauthorized.

        Registered tokens authorize UPLOADS only; destructive actions
        (delete) stay behind the master token — open registration must
        not be an anonymous path to removing other people's models."""
        presented = handler.headers.get("X-Forge-Token")
        if self.token is not None and presented == self.token:
            return "master"
        entry = self._load_tokens()["tokens"].get(presented or "")
        if entry:
            return entry.get("email", "registered")
        return "anonymous" if self.token is None else None

    def _may_delete(self, identity):
        return identity == "master" or self.token is None

    def start(self):
        from http.server import BaseHTTPRequestHandler
        from veles_tpu_torch.core.httpd import (BodyTooLarge,
                                                enable_metrics,
                                                QuietHandlerMixin,
                                                read_body, reply,
                                                serve_metrics,
                                                start_server)

        # this front holds the metric history's sampler until stop()
        enable_metrics(self)
        server = self

        class Handler(QuietHandlerMixin, BaseHTTPRequestHandler):
            def _query(self):
                parsed = urllib.parse.urlparse(self.path)
                return parsed.path, dict(urllib.parse.parse_qsl(
                    parsed.query))

            def do_GET(self):
                path, query = self._query()
                if serve_metrics(self):
                    return
                if path == "/service":
                    if query.get("query") == "list":
                        reply(self, server.list_models())
                    elif query.get("query") == "details":
                        name = query.get("name", "")
                        meta = server.details(name) \
                            if server._safe_name(name) else None
                        if meta is None:
                            reply(self, {"error": "unknown model"},
                                  code=404)
                        else:
                            reply(self, dict(meta, name=name))
                    elif query.get("query") == "history":
                        name = query.get("name", "")
                        hist = server.history(name) \
                            if server._safe_name(name) else None
                        if hist is None:
                            reply(self, {"error": "unknown model"},
                                  code=404)
                        else:
                            reply(self, hist)
                    elif query.get("query") == "diff":
                        name = query.get("name", "")
                        delta = server.diff(name, query.get("from", ""),
                                            query.get("to", "")) \
                            if server._safe_name(name) else None
                        if delta is None:
                            reply(self, {"error": "unknown model or "
                                                  "version"}, code=404)
                        else:
                            reply(self, delta)
                    else:
                        reply(self, {"error": "unknown query"}, code=400)
                elif path == "/fetch":
                    name = query.get("name", "")
                    blob = server.fetch(name, query.get("version")) \
                        if server._safe_name(name) else None
                    if blob is None:
                        reply(self, {"error": "not found"}, code=404)
                    else:
                        reply(self, blob, 200, "application/gzip")
                else:
                    self.send_error(404)

            def do_POST(self):
                path, query = self._query()
                if path == "/register":
                    # the account-creation path is open (the reference
                    # gated it by email confirmation; no mailer here)
                    try:
                        body = json.loads(read_body(self).decode())
                        reply(self, server.register(
                            body.get("email", "")))
                    except BodyTooLarge:
                        pass  # 413 already sent
                    except (ValueError, TypeError) as exc:
                        reply(self, {"error": str(exc)}, code=400)
                    return
                identity = server._authorized(self)
                if identity is None:
                    reply(self, {"error": "bad token"}, code=403)
                    return
                if path == "/upload":
                    try:
                        # packages are weight archives — far larger
                        # than the shared JSON-request body cap
                        reply(self, server.upload(
                            read_body(self, limit=UPLOAD_MAX_BODY),
                            query.get("version"),
                            uploaded_by=identity))
                    except BodyTooLarge:
                        pass  # 413 already sent
                    except PermissionError as exc:
                        reply(self, {"error": str(exc)}, code=403)
                    except pkg.TamperedPackageError as exc:
                        # 422: the request was well-formed but its
                        # artifact bytes are not what they claim
                        reply(self, {"error": str(exc)}, code=422)
                    except (ValueError, TypeError, OSError) as exc:
                        reply(self, {"error": str(exc)}, code=400)
                elif path == "/delete":
                    if not server._may_delete(identity):
                        reply(self, {"error": "delete needs the master "
                                              "token"}, code=403)
                        return
                    name = query.get("name", "")
                    ok = server.delete(name, query.get("version")) \
                        if server._safe_name(name) else False
                    reply(self, {"deleted": ok},
                          code=200 if ok else 404)
                else:
                    self.send_error(404)

        self._httpd, self.port = start_server(
            Handler, self.host, self.port, name="forge-server")
        self.info("forge server on http://%s:%d/", self.host, self.port)
        return self

    def stop(self):
        from veles_tpu_torch.observe.history import release_history_sampler

        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        release_history_sampler(self)

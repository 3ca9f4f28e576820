"""AOT bundles: the built kernel libraries of a serving configuration.

The port of ``veles_tpu/aot/artifact.py``. The JAX package exports its
jitted programs as StableHLO; eager PyTorch traces nothing, and what a
fresh process compiles is the ``nvcc`` build of each kernel library it
launches (``ops/_build.py``). So a bundle here carries those libraries,
in the JAX package's byte format:

- an uncompressed ustar tar whose members are content-addressed:
  ``programs/<sha256-of-bytes>`` (each built library, ``.so`` bytes) and
  ``verdicts/<sha256>`` (the tuning cache's verdicts the dispatches read,
  where the cache has them);
- ``manifest.json``: one row per program the decoder dispatches, named as
  its ``observe/xla_stats`` program (``decode.admit``, ``paged.admit``,
  ``paged.admit_tail``, ``paged.admit_hit``, ``decode.dispatch``,
  ``paged.dispatch``; the tick's ``fused.train_step`` and
  ``fused.eval_step``), keyed as the port's decoder keys the dispatch
  (its admission is ragged: no pow2 groups, so the keys are the port's
  own) and listing the libraries it launches; the ``libraries`` rows
  (source stem, source digest, member); and the compatibility fields the
  loader gates on: ``schema``, ``torch``, ``cuda``, ``kernels`` (the
  source digest of every library the rows name), the device
  ``fingerprint`` and ``mesh`` (``{"axes", "devices"}`` of the serving
  mesh a bundle was built for, None for one device: every rank of a mesh
  loads the same libraries, and a rank's dispatches have rank 0's keys);
- a ``.sha256`` sidecar beside the tar, hashed through a write-tee.

Bytes are deterministic (epoch-0 mtimes, sorted members, canonical JSON),
so two builds of the same configuration hash identically. On the CPU the
port launches no kernel: a CPU bundle holds no library, and its rows and
geometry are those a card's bundle has.
"""

import hashlib
import io
import json
import os
import tarfile

import numpy
import torch

MANIFEST = "manifest.json"
#: bundle schema: the loader refuses any other value by name
SCHEMA_VERSION = 1
BUNDLE_KIND = "veles-aot-bundle"

#: the tuning cache's verdict kinds a library's dispatches read
#: (``ops/gemm.py`` keys: ``int8:KxN``, ``pgatt:PSxD``, ``<dtype>:<bucket>``)
VERDICT_KINDS = {
    "int8_matmul": ("int8:",),
    "paged_attention": ("pgatt:",),
    "paged_attention_int8": ("pgatt:",),
    "gemm": ("bfloat16:", "float32:", "float16:"),
    "dense_epilogue": ("bfloat16:", "float32:", "float16:"),
}


def fingerprint_for(device):
    """The device fingerprint a bundle for ``device`` records and the
    loader holds it to: ``observe/regress.device_fingerprint`` for the
    card (no card: no device kind, so nothing built for one matches),
    the CPU's own for a CPU decoder (even on a host with a card)."""
    from veles_tpu_torch.observe.regress import device_fingerprint

    fp = device_fingerprint()
    if torch.device(device).type == "cpu":
        fp.update(backend="cpu", device_kind="cpu", device_count=1)
    elif not torch.cuda.is_available():
        fp.update(backend="cuda", device_kind=None, device_count=0)
    return fp


def _aval_rows(tree):
    """The manifest record of a program's tensor operands: ``[shape,
    dtype]`` per tensor or array leaf, in ``device.tree_leaves_with_path``
    order (dict keys sorted)."""
    from veles_tpu_torch.device import tree_leaves_with_path

    rows = []
    for _, leaf in tree_leaves_with_path(tree):
        if isinstance(leaf, torch.Tensor):
            rows.append([list(leaf.shape),
                         str(leaf.dtype).replace("torch.", "")])
        elif isinstance(leaf, numpy.ndarray):
            rows.append([list(leaf.shape), str(leaf.dtype)])
    return rows


# -- packing -----------------------------------------------------------------

class BundleBuilder:
    """Accumulate program rows and the libraries they launch, then write
    one deterministic sha-addressed bundle. ``meta`` extends the manifest
    (``build_serving_bundle`` records the decoder geometry there). With a
    CUDA ``device`` (the default) every library a row names is built
    (or taken as this process staged it) and packed; with ``"cpu"`` none
    is: the port launches no kernel there."""

    def __init__(self, meta=None, device=None, mesh=None):
        from veles_tpu_torch.device import resolve_device

        self.device = resolve_device(device)
        self.programs = []     # manifest rows
        self.blobs = {}        # member name -> bytes
        self.libraries = {}    # source stem -> library row
        self.manifest = {
            "kind": BUNDLE_KIND,
            "schema": SCHEMA_VERSION,
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "fingerprint": fingerprint_for(self.device),
            "mesh": mesh_field(mesh),
            "kernels": {},
        }
        if meta:
            self.manifest.update(meta)

    def add(self, name, key, libraries=(), args=None):
        """One program row: ``name`` its ``observe/xla_stats`` name,
        ``key`` the dispatch key the decoder (or the tick) looks it up
        by, ``libraries`` the kernel sources it launches, ``args`` an
        example operand tree (only shapes and dtypes are recorded)."""
        libraries = sorted(set(libraries))
        for stem in libraries:
            self.add_library(stem)
        row = {"name": name, "key": list(key), "libraries": libraries}
        if args is not None:
            row["in_avals"] = _aval_rows(args)
        self.programs.append(row)
        return row

    def add_library(self, stem, blob=None):
        """Record the library of ``ops/csrc/<stem>.cu``: its source digest
        under ``kernels`` and its built bytes as a member: ``blob``, or on
        the card this process's library (built first when this process
        has neither built nor staged it)."""
        from veles_tpu_torch.ops import _build

        if stem in self.libraries:
            return self.libraries[stem]
        digest = _build.source_digest(stem)
        self.manifest["kernels"][stem] = digest
        row = {"name": stem, "digest": digest, "member": None,
               "sha256": None, "bytes": 0}
        if blob is None and self.device.type == "cuda":
            path = _build.staged_path(stem)
            if path is None:
                _build.build((stem,))
                path = _build.library_path(stem)
            with open(path, "rb") as fin:
                blob = fin.read()
        if blob is not None:
            sha = hashlib.sha256(blob).hexdigest()
            row.update(member="programs/%s" % sha, sha256=sha,
                       bytes=len(blob))
            self.blobs[row["member"]] = blob
        self.libraries[stem] = row
        return row

    def add_verdicts(self):
        """Pack the tuning cache's verdicts for this card that the
        recorded libraries' dispatches read (``VERDICT_KINDS``), where
        the cache has them. None on the CPU: verdicts are the card's."""
        if self.device.type != "cuda":
            return None
        from veles_tpu_torch.ops import gemm

        tag = gemm.device_tag(self.device) + "|"
        kinds = tuple(kind for stem in self.libraries
                      for kind in VERDICT_KINDS.get(stem, ()))
        entries = {key: value for key, value in gemm._load_cache().items()
                   if key.startswith(tag)
                   and key[len(tag):].startswith(kinds)}
        if not entries:
            return None
        blob = json.dumps(entries, indent=1, sort_keys=True).encode()
        sha = hashlib.sha256(blob).hexdigest()
        member = "verdicts/%s" % sha
        self.blobs[member] = blob
        self.manifest["verdicts"] = {"member": member, "sha256": sha,
                                     "bytes": len(blob),
                                     "count": len(entries)}
        return member

    def write(self, path):
        """Write the bundle tar and its ``.sha256`` sidecar, byte for
        byte deterministic: epoch-0 mtimes, zero uid/gid, members sorted,
        canonical manifest JSON."""
        from veles_tpu_torch.snapshotter import _HashingWriter

        path = str(path)
        self.add_verdicts()
        manifest = dict(
            self.manifest,
            programs=sorted(self.programs,
                            key=lambda r: (r["name"], r["key"])),
            libraries=[self.libraries[stem]
                       for stem in sorted(self.libraries)])
        payload = json.dumps(manifest, indent=1, sort_keys=True).encode()
        members = [(MANIFEST, payload)] + sorted(self.blobs.items())
        tmp = path + ".tmp%d" % os.getpid()
        with open(tmp, "wb") as raw:
            tee = _HashingWriter(raw)
            with tarfile.open(fileobj=tee, mode="w",
                              format=tarfile.USTAR_FORMAT) as tar:
                for name, blob in members:
                    info = tarfile.TarInfo(name)
                    info.size = len(blob)
                    info.mtime = 0
                    info.uid = info.gid = 0
                    info.uname = info.gname = ""
                    tar.addfile(info, io.BytesIO(blob))
            digest = tee.hexdigest()
        os.replace(tmp, path)
        sidecar = path + ".sha256"
        tmp = sidecar + ".tmp%d" % os.getpid()
        with open(tmp, "w") as fout:
            fout.write("%s  %s\n" % (digest, os.path.basename(path)))
        os.replace(tmp, sidecar)
        return path


# -- serving capture ---------------------------------------------------------

def _buckets(max_len):
    """``ContinuousDecoder.bucket_for``'s image: powers of two from 16,
    clamped to ``max_len``."""
    out, b = [], 16
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(max_len)
    return sorted(set(out))


def _spans(tile, max_len):
    """``ContinuousDecoder._attended_span``'s image: multiples of the
    tile, clamped to ``max_len``."""
    out, s = [], tile
    while s < max_len:
        out.append(s)
        s += tile
    out.append(max_len)
    return sorted(set(out))


def decoder_geometry(dec):
    """The shape identity of a decoder, the JAX package's fields: what
    determines the programs it dispatches. The loader refuses a bundle
    whose geometry differs, naming the field."""
    return {
        "n_blocks": len(dec.params["blocks"]),
        "embed": int(dec.embed_table.shape[1]),
        "vocab": int(dec.embed_table.shape[0]),
        "heads": int(dec.heads),
        "dtype": str(dec.embed_table.dtype).replace("torch.", ""),
        "slots": int(dec.slots),
        "max_len": int(dec.max_len),
        "tile": int(dec.tile),
        "quantize": dec.quantize or "none",
        "paged": bool(dec.paged),
        "page_size": dec.page_size,
        "pool_pages": dec.pool_pages,
        "sample": bool(dec.temperature),
        "top_k": int(dec.top_k),
        "mesh_axis": (dec.mesh_axis if getattr(dec, "_tp", None)
                      is not None else None),
    }


def mesh_field(mesh):
    """The manifest's ``mesh`` field (``artifact.py:221-240``): the axes
    and device count of a serving mesh of more than one device, else
    None."""
    if mesh is None or mesh.size <= 1:
        return None
    return {"axes": {name: int(size)
                     for name, size in dict(mesh.shape).items()},
            "devices": int(mesh.size)}


def serving_libraries(dec, name, width=0):
    """The kernel sources program ``name`` of decoder ``dec`` launches on
    the card: K2 (``int8_matmul``) for every projection of the int8
    tiers, flash (K7) in a prefill the flash rule takes at ``width``
    positions, K4 in the dense int8-KV tier's dispatch, K1 or K3 in the
    pool's; an admission hit writes control rows only."""
    from veles_tpu_torch.ops.attention import uses_flash

    proj = ["int8_matmul"] if dec.quantize else []
    if name in ("decode.admit", "paged.admit"):
        head_dim = int(dec.embed_table.shape[1]) // int(dec.heads)
        return proj + (["flash_attention"]
                       if uses_flash(width, width, head_dim) else [])
    if name == "paged.admit_tail":
        return proj
    if name == "decode.dispatch":
        return proj + (["cache_attend_int8"]
                       if dec.quantize == "int8-kv" else [])
    if name == "paged.dispatch":
        return proj + (["paged_attention_int8"]
                       if dec.quantize == "int8-kv"
                       else ["paged_attention"])
    return []


def serving_rows(dec, chunk, buckets=None):
    """``(name, key, width)`` of every program the decoder dispatches:
    the slab's admission per prompt bucket and its dispatch per (steps,
    attended span); the pool's cold admission per page-rounded width,
    tail per (width, prefix pages) (none in the int8-KV tier, which
    takes exact hits only), hit, and dispatch per (steps, table pages).
    The steps are the serving front's ``chunk`` and 1 (:meth:`step`, the probe's
    single steps)."""
    from veles_tpu_torch.parallel.kv_pool import pages_for

    rows = []
    steps = sorted({1, int(chunk)})
    if dec.paged:
        ps = dec.page_size
        widest = pages_for(dec.max_len - 1, ps)
        for pages in range(1, widest + 1):
            rows.append(("paged.admit", ("paged_admit", pages * ps),
                         pages * ps))
        if dec.quantize != "int8-kv":
            for prefix in range(1, widest):
                tail_max = pages_for(dec.max_len - 1 - prefix * ps, ps)
                for pages in range(1, tail_max + 1):
                    rows.append(("paged.admit_tail",
                                 ("paged_tail", pages * ps, prefix),
                                 pages * ps))
        rows.append(("paged.admit_hit", ("paged_hit",), 0))
        # the lag-1 pipeline's overshoot bound: a live lane can stand at
        # max_len - 1 + chunk and the next table adds another chunk
        pb_max = pages_for(dec.max_len - 1 + 2 * int(chunk), ps)
        for n in steps:
            for pb in range(1, pb_max + 1):
                rows.append(("paged.dispatch", ("paged_dispatch", n, pb),
                             0))
    else:
        for bucket in buckets or _buckets(dec.max_len):
            rows.append(("decode.admit", ("admit", bucket), bucket))
        for n in steps:
            for span in _spans(dec.tile, dec.max_len):
                rows.append(("decode.dispatch", ("dispatch", n, span), 0))
    return rows


def build_serving_bundle(params, embed_table, heads, path, *, slots=4,
                         max_len=512, n_tokens=32, chunk=8,
                         temperature=0.0, top_k=0, quantize=None,
                         tile=None, paged=False, page_size=None,
                         pool_pages=None, buckets=None, progress=None,
                         mesh=None, mesh_axis="model", device=None):
    """Record every program a :class:`~veles_tpu_torch.serving.
    ContinuousDecoder` of this configuration dispatches, with the
    libraries each launches, and write the bundle to ``path``.

    The geometry comes from a real decoder built with the SAME kwargs
    (then discarded), as in the JAX package, so the recorded keys never
    drift from what serving dispatches: the int8-KV tier's ``max_len``
    rounding and the pool's sizing defaults included. With a ``mesh``
    (``mesh_axis`` sharded) the bundle is for every rank of that serving
    mesh: the mesh is validated against the weights
    (``decode.validate_slot_mesh``) and recorded, and needs no world to
    build (a rank's dispatches carry rank 0's keys and launch the same
    libraries)."""
    from veles_tpu_torch.parallel.decode import validate_slot_mesh
    from veles_tpu_torch.serving import ContinuousDecoder

    dec = ContinuousDecoder(
        params, embed_table, heads, slots=slots, max_len=max_len,
        n_tokens=n_tokens, temperature=temperature, top_k=top_k,
        quantize=quantize, tile=tile, paged=paged, page_size=page_size,
        pool_pages=pool_pages, device=device)
    geometry = decoder_geometry(dec)
    if mesh_field(mesh) is not None:
        validate_slot_mesh(mesh, heads, dec.params, dec.embed_table,
                           axis=mesh_axis)
        geometry["mesh_axis"] = mesh_axis
    bundle = BundleBuilder(
        meta={"geometry": geometry, "chunk": int(chunk),
              "n_tokens": int(n_tokens)},
        device=dec.device, mesh=mesh)
    for name, key, width in serving_rows(dec, chunk, buckets):
        if progress is not None:
            progress(name, key)
        bundle.add(name, key, serving_libraries(dec, name, width))
    return bundle.write(path)


def tick_libraries(specs):
    """The kernel sources the fused tick of ``specs`` launches on the
    card under the engine knobs: K5 (``gemm``) in a dense layer's products
    where ``root.common.engine.use_pallas`` routes them, K6
    (``dense_epilogue``) in its forward with ``pallas_epilogue`` on too,
    and the flash kernels (K7 forward, K8 and K9 backward) in an
    attention block."""
    from veles_tpu_torch.core.config import root

    engine = root.common.engine
    out = set()
    for spec in specs:
        if spec.get("kind") == "dense":
            if engine.get("use_pallas", "tuned"):
                out.add("gemm")
            if engine.get("use_pallas", False) \
                    and engine.get("pallas_epilogue", False):
                out.add("dense_epilogue")
        elif spec.get("kind") == "attention":
            out.update(("flash_attention", "flash_attention_bwd"))
    return sorted(out)


def workflow_tick(workflow):
    """What capturing the fused tick of an initialized workflow takes:
    ``(specs, train_args, eval_args, install_kwargs)``, the example
    operands shaped as ``FusedTick.run`` passes them (one minibatch of
    the loader's size) and the ``build_tick`` knobs
    (``parallel/fused.tick_config``) the tick was built with."""
    from veles_tpu_torch.parallel.fused import (get_hypers, get_params,
                                                tick_config)

    specs, norm_type, install = tick_config(workflow)
    tick = workflow.fused_tick
    loader = workflow.loader
    data = loader.original_data.data
    labels = (loader.original_targets.data
              if install["loss_kind"] == "mse"
              else loader.labels_for_gather())
    indices = torch.from_numpy(numpy.zeros_like(
        loader.minibatch_indices.data)).to(data.device)
    valid = float(indices.shape[0])
    params = get_params(workflow, specs)
    train = (params, get_hypers(workflow), tick._norm_, data, labels,
             indices, valid, 0)
    evals = (params, tick._norm_, data, labels, indices, valid)
    return specs, train, evals, dict(install, norm_type=norm_type)


def capture_tick_programs(bundle, steps, train_args, eval_args=None,
                          specs=None):
    """Record the fused training tick (``parallel/fused.build_tick``'s
    steps) in ``bundle`` (a :class:`BundleBuilder`): the train step keyed by its minibatch
    (``("train_step", mb)``, mb the length of ``indices``) and, with
    ``eval_args``, the eval step, each with the libraries the tick of
    ``specs`` launches (``tick_libraries``) and its operands' shapes.
    ``steps`` is taken for the JAX package's signature: eager PyTorch
    has nothing of a step to serialize."""
    del steps
    libraries = tick_libraries(specs or ())
    mb = int(numpy.shape(train_args[5])[0])  # indices (mb,)
    bundle.add("fused.train_step", ("train_step", mb), libraries,
               args=tuple(train_args[:7]))
    if eval_args is not None:
        bundle.add("fused.eval_step",
                    ("eval_step", int(numpy.shape(eval_args[4])[0])),
                   libraries, args=tuple(eval_args[:6]))
    return bundle


# -- reading -----------------------------------------------------------------

def read_bundle(path, verify=True):
    """Read a bundle: ``(manifest, members)``, members a {name: bytes}
    dict. ``verify`` checks the ``.sha256`` sidecar (when present) and
    every member's content hash against its sha-addressed name and its
    manifest row: a tampered or torn bundle raises ``ValueError`` naming
    the member, and nothing loads."""
    path = str(path)
    if verify:
        sidecar = path + ".sha256"
        if os.path.isfile(sidecar):
            from veles_tpu_torch.observe.regress import sha256_of
            with open(sidecar) as fin:
                fields = fin.read().split()
            if not fields or fields[0] != sha256_of(path):
                raise ValueError(
                    "%s does not match its .sha256 sidecar" % path)
    members = {}
    try:
        with tarfile.open(path, "r") as tar:
            for member in tar.getmembers():
                if member.isfile():
                    members[member.name] = tar.extractfile(member).read()
    except tarfile.TarError as exc:
        raise ValueError("%s is not a readable bundle tar: %s"
                         % (path, exc))
    if MANIFEST not in members:
        raise ValueError("%s has no %s" % (path, MANIFEST))
    try:
        manifest = json.loads(members[MANIFEST].decode())
    except ValueError:
        raise ValueError("%s: manifest.json is not valid JSON" % path)
    if manifest.get("kind") != BUNDLE_KIND:
        raise ValueError("%s is not a %s (kind=%r)"
                         % (path, BUNDLE_KIND, manifest.get("kind")))
    if verify:
        rows = [row for row in manifest.get("libraries", ())
                if row.get("member")]
        if manifest.get("verdicts"):
            rows.append(manifest["verdicts"])
        for row in rows:
            blob = members.get(row["member"])
            if blob is None:
                raise ValueError("%s: manifest names missing member %s"
                                 % (path, row["member"]))
            digest = hashlib.sha256(blob).hexdigest()
            if digest != row["sha256"] \
                    or not row["member"].endswith(digest):
                raise ValueError(
                    "%s: member %s content hash %s does not match its "
                    "sha-addressed name" % (path, row["member"], digest))
    return manifest, members


def inspect_bundle(path):
    """Manifest summary for ``python -m veles_tpu_torch aot inspect``."""
    manifest, _ = read_bundle(path, verify=False)
    programs = manifest.get("programs", [])
    libraries = manifest.get("libraries", [])
    by_name = {}
    for row in programs:
        entry = by_name.setdefault(row["name"], {"programs": 0,
                                                 "libraries": []})
        entry["programs"] += 1
        entry["libraries"] = sorted(set(entry["libraries"])
                                    | set(row.get("libraries", ())))
    return {
        "path": str(path),
        "schema": manifest.get("schema"),
        "torch": manifest.get("torch"),
        "cuda": manifest.get("cuda"),
        "fingerprint": manifest.get("fingerprint"),
        "mesh": manifest.get("mesh"),
        "geometry": manifest.get("geometry"),
        "chunk": manifest.get("chunk"),
        "kernels": manifest.get("kernels"),
        "programs": len(programs),
        "by_name": by_name,
        "libraries": {row["name"]: row.get("bytes", 0)
                      for row in libraries},
        "verdicts": (manifest.get("verdicts") or {}).get("count", 0),
        "total_bytes": sum(row.get("bytes", 0) for row in libraries)
        + (manifest.get("verdicts") or {}).get("bytes", 0),
    }

"""``python -m veles_tpu_torch aot build|inspect|verify|warm-cache``.

The port of ``veles_tpu/aot/cli.py``:

- ``build``: record a serving configuration's programs and pack the
  kernel libraries they launch into a bundle (the shapes and the built
  code are the artifact; the weights travel apart, and ``--seed`` only
  draws the shapes' stand-ins);
- ``inspect``: print a bundle's manifest summary;
- ``verify``: check the sidecar, the content-addressed members and the
  compatibility gate against THIS machine: exit 0 loadable, 1 refused
  (the stale field named), 2 unreadable or tampered;
- ``warm-cache``: stage every library NOW into the persistent cache
  beside the bundle (``<bundle>.xcache/``, ``aot/exec_cache.py``) and
  load it, so the next boot on this machine takes verified entries.

``build --forge-dir DIR`` stages the bundle and its sidecar into a forge
package directory (:func:`stage_into_package`): ``forge upload -d DIR``
then ships the kernel libraries and the weights together, and the forge
server verifies the sidecar on receipt (422 on a tampered bundle).

``--mesh`` on ``build`` records the bundle for every rank of that serving
mesh (the libraries are the same on every rank; the build needs no
world); on ``verify`` and ``warm-cache`` it gives the JAX package's
verdict (a single-device bundle is not loadable for a mesh boot, a mesh
bundle for another mesh neither).
"""

import argparse
import json


class _AxesMesh:
    """A requested mesh's axes: all the gate reads of a mesh, and all a
    verdict given outside the mesh's world can know of it."""

    def __init__(self, spec):
        axes = {}
        for part in str(spec).split(","):
            name, sep, size = part.partition("=")
            if not sep or not name.strip() or not size.strip().isdigit():
                raise ValueError("mesh spec %r is not AXIS=N[,AXIS=N...]"
                                 % (spec,))
            axes[name.strip()] = int(size)
        self.shape = axes


def _build(args):
    import numpy
    import torch

    from veles_tpu_torch.aot.artifact import (build_serving_bundle,
                                              inspect_bundle)
    from veles_tpu_torch.parallel.transformer_step import \
        init_transformer_params

    mesh = None
    if args.mesh:
        from veles_tpu_torch.parallel.mesh import Mesh, parse_axes
        mesh = Mesh(parse_axes(args.mesh, flag="--mesh"))
    rng = numpy.random.RandomState(args.seed)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    params = init_transformer_params(rng, args.blocks, args.embed,
                                     args.heads, args.vocab, dtype=dtype,
                                     device=args.device)
    table = torch.from_numpy(
        rng.randn(args.vocab, args.embed).astype("float32") * 0.3
    ).to(dtype=dtype, device=args.device)

    def progress(name, key):
        if args.verbose:
            print("  recording %s %s" % (name, list(key)))

    path = build_serving_bundle(
        params, table, args.heads, args.out, slots=args.slots,
        max_len=args.max_len, n_tokens=args.n_tokens, chunk=args.chunk,
        temperature=args.temperature, top_k=args.top_k,
        quantize=args.quantize if args.quantize != "none" else None,
        tile=args.tile, paged=args.paged, page_size=args.page_size,
        pool_pages=args.pool_pages, progress=progress, mesh=mesh,
        device=args.device)
    if args.forge_dir:
        stage_into_package(path, args.forge_dir)
    print(json.dumps(inspect_bundle(path), indent=1))
    return 0


def stage_into_package(bundle_path, directory):
    """Stage a bundle (+ its sidecar) into a forge package directory
    and list it under the manifest's ``artifacts`` member
    (``veles_tpu/aot/cli.py:61-86``): ``forge upload -d DIR`` then ships
    the kernel libraries and the weights together, and the server
    verifies the sidecar on receipt (422 on tamper). The manifest is
    rewritten as the JAX package writes it (indent 1, sorted keys).
    Returns the bundle's member name."""
    import os
    import shutil

    from veles_tpu_torch.forge.package import MANIFEST

    name = os.path.basename(bundle_path)
    shutil.copy(bundle_path, os.path.join(directory, name))
    shutil.copy(bundle_path + ".sha256",
                os.path.join(directory, name + ".sha256"))
    manifest_path = os.path.join(directory, MANIFEST)
    with open(manifest_path) as fin:
        manifest = json.load(fin)
    artifacts = manifest.setdefault("artifacts", [])
    if name not in artifacts:
        artifacts.append(name)
    tmp = manifest_path + ".tmp"
    with open(tmp, "w") as fout:
        json.dump(manifest, fout, indent=1, sort_keys=True)
    os.replace(tmp, manifest_path)
    return name


def _inspect(args):
    from veles_tpu_torch.aot.artifact import inspect_bundle
    print(json.dumps(inspect_bundle(args.bundle), indent=1))
    return 0


def _mesh_of(args, manifest):
    """The mesh the verdict is given for: the operator's ``--mesh``, else
    the bundle's own axes."""
    if args.mesh:
        return _AxesMesh(args.mesh)
    if manifest.get("mesh") is not None:
        return _AxesMesh(",".join(
            "%s=%d" % item
            for item in sorted((manifest["mesh"].get("axes")
                                or {}).items())))
    return None


def _verify(args):
    from veles_tpu_torch.aot.artifact import read_bundle
    from veles_tpu_torch.aot.loader import AotCompatError, check_compat

    try:
        manifest, _ = read_bundle(args.bundle)
    except (OSError, ValueError) as exc:
        print("UNREADABLE: %s" % exc)
        return 2
    try:
        mesh = _mesh_of(args, manifest)
    except ValueError as exc:
        print("REFUSED: mesh: %s" % exc)
        return 1
    try:
        check_compat(manifest, mesh=mesh)
    except AotCompatError as exc:
        print("REFUSED: %s: %s" % (exc.field, exc))
        return 1
    print("OK: %d programs, loadable on this machine"
          % len(manifest.get("programs", ())))
    return 0


def _warm_cache(args):
    from veles_tpu_torch.aot.artifact import read_bundle
    from veles_tpu_torch.aot.loader import (AotCompatError, _device_of,
                                            check_compat, load_bundle)

    try:
        manifest, _ = read_bundle(args.bundle)
    except (OSError, ValueError) as exc:
        print("UNREADABLE: %s" % exc)
        return 2
    try:
        mesh = _mesh_of(args, manifest)
    except ValueError as exc:
        print("REFUSED: mesh: %s" % exc)
        return 1
    device = _device_of(manifest)
    try:
        check_compat(manifest, mesh=mesh, device=device)
        programs = load_bundle(args.bundle, mesh=mesh, eager=True,
                               prefetch=False,
                               exec_cache=args.cache or True,
                               device=device)
    except AotCompatError as exc:
        print("REFUSED: %s: %s" % (exc.field, exc))
        return 1
    print(json.dumps(programs.stats(), indent=1, sort_keys=True))
    return 0


def main(argv=None):
    parser = argparse.ArgumentParser(prog="veles_tpu_torch aot")
    sub = parser.add_subparsers(dest="action", required=True)

    build = sub.add_parser("build", help="record a serving "
                           "configuration's programs and pack the kernel "
                           "libraries they launch into a bundle")
    build.add_argument("--out", required=True, help="bundle path")
    build.add_argument("--blocks", type=int, default=2)
    build.add_argument("--embed", type=int, default=256)
    build.add_argument("--heads", type=int, default=8)
    build.add_argument("--vocab", type=int, default=2048)
    build.add_argument("--dtype", choices=("float32", "bfloat16"),
                       default="float32")
    build.add_argument("--slots", type=int, default=4)
    build.add_argument("--max-len", type=int, default=512)
    build.add_argument("--n-tokens", type=int, default=32)
    build.add_argument("--chunk", type=int, default=8)
    build.add_argument("--temperature", type=float, default=0.0)
    build.add_argument("--top-k", type=int, default=0)
    build.add_argument("--quantize", choices=("none", "int8", "int8-kv"),
                       default="none")
    build.add_argument("--tile", type=int, default=None)
    build.add_argument("--paged", action="store_true")
    build.add_argument("--page-size", type=int, default=None)
    build.add_argument("--pool-pages", type=int, default=None)
    build.add_argument("--mesh", default=None, metavar="AXIS=N[,AXIS=N...]",
                       help="build for every rank of this serving mesh "
                            "(--serve-mesh), e.g. model=2")
    build.add_argument("--forge-dir", default=None, metavar="DIR",
                       help="stage the bundle into this forge package "
                            "directory (listed under the manifest's "
                            "artifacts)")
    build.add_argument("--seed", type=int, default=0,
                       help="params init seed (shapes only: serve real "
                            "weights apart)")
    build.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                       help="the device the bundle is for (default: the "
                            "card; a CPU bundle holds no library)")
    build.add_argument("-v", "--verbose", action="store_true")
    build.set_defaults(func=_build)

    inspect_p = sub.add_parser("inspect", help="print a bundle's "
                               "manifest summary")
    inspect_p.add_argument("bundle")
    inspect_p.set_defaults(func=_inspect)

    verify = sub.add_parser("verify", help="integrity + compatibility "
                            "check against this machine")
    verify.add_argument("bundle")
    verify.add_argument("--mesh", default=None,
                        metavar="AXIS=N[,AXIS=N...]")
    verify.set_defaults(func=_verify)

    warm = sub.add_parser("warm-cache", help="stage every library into "
                          "the persistent cache beside the bundle and "
                          "load it")
    warm.add_argument("bundle")
    warm.add_argument("--mesh", default=None,
                      metavar="AXIS=N[,AXIS=N...]")
    warm.add_argument("--cache", default=None, metavar="DIR",
                      help="cache directory (default: <bundle>.xcache "
                           "beside the bundle)")
    warm.set_defaults(func=_warm_cache)

    args = parser.parse_args(argv)
    return args.func(args)

"""``python -m veles_tpu_torch deploy rollout PKG``: a forge-driven
zero-downtime rollout in one CLI step.

The port of ``veles_tpu/deploy_cli.py``. One verb chains what operators
otherwise script by hand: resolve the package (a local ``.tar.gz`` path,
or ``name[@version]`` fetched from the forge store), verify every
artifact member against its sha256 sidecar
(``forge/package.py:verify_artifact_members``: a tampered or torn
package is REFUSED before any weight byte is parsed), load the serving
checkpoint member, and hand it to the live
``GenerateAPI.begin_rollout`` stamped with the package's canonical
``name@version`` deploy identity, so the SLO burn slices, the ledger
actuations and any rollback incident all trace back to this package.

Serving checkpoint convention: the manifest's ``weights`` key (default
``weights.npz``) names an ``.npz`` member holding the flattened leaves
of ``(params, embed_table)`` in ``jax.tree.flatten`` order
(:func:`~veles_tpu_torch.device.tree_leaves_with_path`: dict keys
sorted, lists in order), keyed ``leaf_00000...``: written by
:func:`save_serving_checkpoint`, re-assembled against the LIVE api's
tree structure (the swap seam re-validates shapes and dtypes; a
mismatched checkpoint is refused there). The bytes are the JAX
package's: a bfloat16 leaf is stored as numpy writes JAX's bfloat16
arrays (raw two-byte records, descr ``<V2``), and read back as bfloat16 where
the live leaf is one, so a checkpoint either package wrote rolls into
the other's api (each member's bytes equal; the zip's time stamps are
the writing moment's in both). One difference: ``name[@version]`` is
fetched as the package's bytes, where the JAX package's
``_resolve_package`` unpacks the fetch into a directory and then reads
that directory as a file, so its forge path never resolves.

Exit-code matrix (``veles_tpu/deploy_cli.py:21-34``):

====  ======================================================
code  meaning
====  ======================================================
0     rollout began (the ramp proceeds under the live
      predicate; promotion/rollback is the rollout's job)
2     package unavailable or malformed (fetch failed, not an
      archive, manifest invalid, weights member absent)
3     tampered package (an artifact member's bytes do not
      match its sha256 sidecar)
4     no live serving api in this process, or the rollout was
      refused (one already in flight / checkpoint rejected)
====  ======================================================
"""

import argparse
import io
import json
import os
import sys
import tarfile

#: exit codes (the matrix above)
EXIT_OK = 0
EXIT_PACKAGE = 2
EXIT_TAMPERED = 3
EXIT_ROLLOUT = 4

#: default serving-checkpoint member name
WEIGHTS_MEMBER = "weights.npz"


def _write_leaf(fid, leaf):
    """One leaf's ``.npy`` bytes as ``numpy.savez`` writes JAX's
    ``numpy.asarray`` of it: a bfloat16 tensor as two-byte records under
    ml_dtypes' descr ``<V2`` (numpy needs no ml_dtypes to read it)."""
    import numpy
    import torch
    from numpy.lib import format as npy

    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            codes = leaf.contiguous().view(torch.int16).numpy()
            header = npy.header_data_from_array_1_0(codes)
            header["descr"] = "<V2"
            npy.write_array_header_1_0(fid, header)
            fid.write(codes.tobytes("C"))
            return
        leaf = leaf.numpy()
    npy.write_array(fid, numpy.asanyarray(leaf))


def _leaf_tensor(array, like):
    """A checkpoint leaf as a tensor: raw two-byte records become
    bfloat16 where the live leaf is one, int16 elsewhere (a mismatch is
    left for the swap seam to refuse, as the JAX package leaves it)."""
    import torch

    if array.dtype.kind == "V" and array.dtype.itemsize == 2:
        codes = torch.from_numpy(array.view("int16").copy())
        if getattr(like, "dtype", None) == torch.bfloat16:
            return codes.view(torch.bfloat16)
        return codes
    return torch.from_numpy(array.copy())


def _unflatten(like, leaves):
    """``like``'s tree with its leaves taken in order from the iterator
    ``leaves`` (``jax.tree.unflatten`` over the port's trees)."""
    if isinstance(like, dict):
        return {key: _unflatten(like[key], leaves) for key in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(val, leaves) for val in like)
    return _leaf_tensor(next(leaves), like)


def save_serving_checkpoint(fileobj, params, embed_table):
    """Write the ``(params, embed_table)`` tree as the package's
    ``weights.npz`` member payload: flattened leaves in
    ``jax.tree.flatten`` order, keyed ``leaf_00000...``, in the zip
    layout ``numpy.savez`` writes (stored, zip64 members)."""
    import zipfile

    from veles_tpu_torch.device import tree_leaves_with_path

    leaves = [leaf for _, leaf in
              tree_leaves_with_path((params, embed_table))]
    with zipfile.ZipFile(fileobj, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as archive:
        for i, leaf in enumerate(leaves):
            with archive.open("leaf_%05d.npy" % i, "w",
                              force_zip64=True) as fid:
                _write_leaf(fid, leaf)


def load_serving_checkpoint(data, like_params, like_table):
    """Re-assemble a ``weights.npz`` payload against the live api's
    tree structure; returns ``(params, embed_table)`` as CPU tensors.
    Raises ValueError on a leaf-count mismatch (the swap seam validates
    shapes and dtypes per leaf afterwards)."""
    import numpy

    from veles_tpu_torch.device import tree_leaves_with_path

    archive = numpy.load(io.BytesIO(data))
    leaves = [archive[key] for key in sorted(archive.files)]
    like = (like_params, like_table)
    want = len(tree_leaves_with_path(like))
    if len(leaves) != want:
        raise ValueError(
            "checkpoint has %d leaves but the serving params have %d"
            % (len(leaves), want))
    return _unflatten(like, iter(leaves))


def _resolve_package(spec, forge_url, token):
    """``spec`` -> package bytes: a local file path wins; otherwise
    ``name[@version]`` is fetched from the forge store."""
    if os.path.isfile(spec):
        with open(spec, "rb") as fin:
            return fin.read()
    from veles_tpu_torch.forge.client import ForgeClient

    name, _, version = spec.partition("@")
    client = ForgeClient(forge_url, token=token)
    # the package's bytes as the store holds them: the JAX package
    # unpacks the fetch into a directory named pkg.tar.gz and then opens
    # that directory as a file, so its forge path always exits 2
    return client.fetch_blob(name, version=version or None)


def _extract_weights(blob, manifest):
    member = manifest.get("weights", WEIGHTS_MEMBER)
    with tarfile.open(fileobj=io.BytesIO(blob), mode="r:gz") as tar:
        try:
            return tar.extractfile(tar.getmember(member)).read()
        except KeyError:
            raise ValueError(
                "package has no serving checkpoint member %r" % member)


def rollout_package(spec, api=None, forge_url=None, token=None,
                    timeout=120.0, out=None):
    """The ``deploy rollout`` verb's engine; returns an exit code from
    the matrix. ``api`` defaults to this process's live
    ``GenerateAPI`` (``serving.get_current_api``), the injectable seam
    the exit-code matrix test drives."""
    from veles_tpu_torch.forge.package import (TamperedPackageError,
                                               deploy_version,
                                               verify_artifact_members)
    out = out if out is not None else sys.stderr
    try:
        blob = _resolve_package(spec, forge_url, token)
    except Exception as err:
        print("deploy rollout: cannot resolve package %r: %s"
              % (spec, err), file=out)
        return EXIT_PACKAGE
    try:
        manifest = verify_artifact_members(blob)
    except TamperedPackageError as err:
        print("deploy rollout: REFUSING tampered package: %s" % err,
              file=out)
        return EXIT_TAMPERED
    except Exception as err:
        print("deploy rollout: malformed package: %s" % err, file=out)
        return EXIT_PACKAGE
    try:
        payload = _extract_weights(blob, manifest)
    except Exception as err:
        print("deploy rollout: %s" % err, file=out)
        return EXIT_PACKAGE
    if api is None:
        from veles_tpu_torch.serving import get_current_api
        api = get_current_api()
    if api is None:
        print("deploy rollout: no live serving api in this process",
              file=out)
        return EXIT_ROLLOUT
    version = deploy_version(manifest)
    try:
        like = api.decoder
        params, table = load_serving_checkpoint(
            payload, like.params, like.embed_table)
    except Exception as err:
        print("deploy rollout: checkpoint unreadable: %s" % err,
              file=out)
        return EXIT_PACKAGE
    try:
        api.begin_rollout(params, new_embed_table=table,
                          version=version, timeout=timeout)
    except Exception as err:
        print("deploy rollout: rollout refused: %s" % err, file=out)
        return EXIT_ROLLOUT
    print(json.dumps({"rollout": version, "status": "shifting"}),
          file=out)
    return EXIT_OK


def main(argv=None, api=None):
    """``veles_tpu_torch deploy <verb>`` dispatcher (today:
    ``rollout``)."""
    parser = argparse.ArgumentParser(
        prog="veles_tpu_torch deploy",
        description="zero-downtime deploy verbs "
                    "(docs/zero_downtime.md)")
    sub = parser.add_subparsers(dest="verb", required=True)
    ro = sub.add_parser(
        "rollout",
        help="fetch + sha-verify + begin_rollout in one step")
    ro.add_argument("package",
                    help="local package path or forge name[@version]")
    ro.add_argument("--forge-url", default=None,
                    help="forge store base URL (for name[@version])")
    ro.add_argument("--token", default=None)
    ro.add_argument("--timeout", type=float, default=120.0,
                    help="green build+probe budget (seconds)")
    args = parser.parse_args(argv)
    if args.verb == "rollout":
        return rollout_package(args.package, api=api,
                               forge_url=args.forge_url,
                               token=args.token,
                               timeout=args.timeout, out=sys.stderr)
    parser.error("unknown verb %r" % args.verb)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

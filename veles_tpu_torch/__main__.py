"""Command-line entry point: ``python -m veles_tpu_torch <workflow.py>
<config.py> [root.x=y ...]``.

The port of ``veles_tpu/__main__.py:31-727`` (reference
``veles/__main__.py``). The workflow module contract is the JAX
package's: the module defines ``run(load, main)`` where

    load(WorkflowClass, **kwargs) -> (workflow, snapshot_loaded)
    main(**kwargs)  # initializes and runs the launcher

The layering is the JAX package's too: the workflow module first (its
``root`` updates are defaults), then the config file (executable Python
run with ``root`` injected), then the ``root.a.b=value`` overrides.
``-w`` resumes from a snapshot: a file, its ``_current.lnk``, a
``sqlite://db#prefix[/suffix]`` row or an ``http(s)://`` URL downloaded
first.

``--device {cuda,cpu}`` (default ``cuda``) is the port's counterpart of
``JAX_PLATFORMS``: ``load`` passes it to the workflow class and to the
snapshot import. Without a card, ``cuda`` raises; nothing falls back to
the CPU.

``--trace-events PATH`` turns the tracer on and appends the span events
(``unit.run``, ``workflow.run``, ...) to a JSONL file, which ``python -m
veles_tpu_torch observe export-trace PATH`` turns into a Chrome trace;
``--profile DIR`` runs the workflow inside the ``torch.profiler`` window
(``observe/profile.py``). SIGTERM dumps the flight recorder's black box
before the previous handler runs (``observe/flight.py``).

``-l/--listen HOST:PORT`` makes the run a fleet master and
``-m/--master-address HOST:PORT`` a slave (``fleet/``,
``launcher.py``); ``-n/--nodes`` spawns slaves from the master,
``--respawn`` relaunches dead ones, ``--async-slave`` pipelines a
slave's requests, ``--fleet-plane`` picks the wire plane,
``--slave-death-probability`` and the ``--chaos-*`` flags inject faults
(they land in ``root.common.fleet``, ``__main__.py:583-646``), and
``-b`` re-executes the command detached, its output in
``<root.common.dirs.cache>/daemon.log``.

``--mesh data=N`` runs the fused tick data-parallel over a
``torch.distributed`` world of N processes, one per device
(``parallel/mesh.py``): start the same command once per process with
``--coordinator HOST:PORT --num-processes N --process-id I`` (rank 0
serves the rendezvous and alone writes snapshots, plots, web status and
the result file); ``--fleet-reduce {f32,bf16,int8}`` picks the gradient
reduce's wire tier (``parallel/mapreduce.py``). With ``-m HOST:PORT`` the
same flags start a pod slave, a fleet slave over that world
(``fleet/pod.py``): rank 0 connects to the master, the other ranks follow
its jobs. ``root.common.mesh.timeout`` (seconds) bounds every wait in the
world. ``--serve-mesh model=N`` (validated at once, written to
``root.common.serve.mesh``) serves tensor-parallel over such a world: the
workflow's ``GenerateAPI`` on rank 0 serves, on every other rank it
follows rank 0's decoder (``parallel/tp_engine.py``).

``--optimize SIZE:GENERATIONS`` (with ``--optimize-fleet`` and
``--optimize-representation``), ``--ensemble-train N:RATIO`` and
``--ensemble-test FILE`` run the meta-workflows (``genetics/``,
``ensemble/``): each evaluation or instance a child run of this command
with its overrides and ``--device``.

The flags of paths the port does not have yet parse like the JAX
package's, then exit with code 2 and a message naming the ROADMAP item
that brings them (:data:`DEFERRED`); so do the JAX package's
subcommands that are not ported yet (:data:`DEFERRED_COMMANDS`). The
ported subcommands (:data:`COMMANDS`): ``parity`` (``parity.main``),
``autotune`` (``ops/gemm.autotune_main``), ``aot`` (``aot/cli.main``:
``build``, ``inspect``, ``verify``, ``warm-cache``) and ``observe``
(``observe/trace_export.main``: ``export-trace``, ``blackbox``, ``slo``,
``serve-trace``, ``incident``, ``record``, ``replay``, ``capacity`` and
``regress``), ``forge`` (``forge/client.main``: the model hub's verbs),
``route`` (``router.main``: the elastic router over ``GenerateAPI``
replicas) and ``deploy`` (``deploy_cli.main``: ``deploy rollout`` into
this process's live api). ``--serve-slo`` and ``--serve-history`` are
validated before the workflow loads and land in ``root.common.observe``;
``--serve-governor`` likewise lands in ``root.common.serve.governor``.
"""

import argparse
import importlib.util
import json
import logging
import os
import runpy
import sys

from veles_tpu_torch.core import prng
from veles_tpu_torch.core.config import root
from veles_tpu_torch.core.logger import Logger, setup_logging
from veles_tpu_torch.launcher import Launcher

#: the fleet's flags (by argparse dest), ported with the fleet
FLEET_FLAGS = ("listen", "master_address", "nodes", "respawn",
               "slave_death_probability", "async_slave", "fleet_plane",
               "chaos_seed", "chaos_frame_drop", "chaos_frame_delay",
               "chaos_slow_job", "chaos_duplicate_update", "chaos_death")

#: flag -> the ROADMAP item that brings it (by argparse dest)
DEFERRED = {
    "serve_paged_kernel": "not ported, on purpose (ROADMAP A2): on the "
                          "card the paged pool always attends through "
                          "its kernels",
    "manhole": "the debug console, ROADMAP A9",
}

#: the JAX package's subcommands -> the ROADMAP item that brings them
DEFERRED_COMMANDS = {
    "analyze": "the analyzer, ROADMAP A9 (d)",
}


class Main(Logger):
    """The command line's entry (reference ``__main__.py:136``)."""

    def __init__(self):
        super().__init__(logger_name="Main")
        self.launcher = None
        self.workflow = None
        self.snapshot_path = None
        self.device = "cuda"
        self.dry_run = None
        self.visualize = None
        self.dump_unit_attributes = False
        self.profile_dir = None

    @staticmethod
    def init_parser():
        parser = argparse.ArgumentParser(
            prog="veles_tpu_torch",
            description="PyTorch/CUDA dataflow deep-learning framework")
        parser.add_argument("workflow", help="workflow python file")
        parser.add_argument("config", nargs="?", default=None,
                            help="config python file ('-' to skip)")
        parser.add_argument("overrides", nargs="*", default=[],
                            help="root.path=value config overrides")
        parser.add_argument("--device", choices=("cuda", "cpu"),
                            default="cuda",
                            help="where the workflow runs (default: the "
                                 "card; there is no CPU fallback)")
        parser.add_argument("-w", "--snapshot", default=None,
                            help="resume from a snapshot: a file, "
                                 "sqlite://db#prefix or an http(s) URL")
        parser.add_argument("--result-file", default=None,
                            help="write IResultProvider metrics JSON here")
        parser.add_argument("--seed", default=None,
                            help="seed for the named PRNG streams "
                                 "(int, or key=int,key=int)")
        parser.add_argument("--train-ratio", type=float, default=None,
                            help="use only this fraction of the train set")
        parser.add_argument("--dry-run", choices=("load", "init"),
                            default=None,
                            help="stop after loading/initializing")
        parser.add_argument("--visualize", default=None, metavar="PATH",
                            help="write the workflow unit graph as "
                                 "Graphviz DOT after initialize")
        parser.add_argument("--dump-unit-attributes", action="store_true",
                            help="print every unit's post-init state as "
                                 "JSON lines")
        parser.add_argument("--dump-config", action="store_true")
        parser.add_argument("-v", "--verbose", action="count", default=0)
        mesh = parser.add_argument_group(
            "mesh", "the data-parallel fused tick over a torch.distributed "
            "world, one process per device")
        mesh.add_argument("--mesh", default=None,
                          metavar="AXIS=N[,AXIS=N...]",
                          help="pod mode: shard the workflow tick over a "
                               "device mesh, e.g. --mesh data=2 (axes: "
                               "pipe, data, expert, seq, model; -1 "
                               "absorbs the remaining devices; only the "
                               "data axis is ported)")
        mesh.add_argument("--coordinator", default=None,
                          metavar="HOST:PORT",
                          help="multi-process pod: the rendezvous that "
                               "rank 0 serves (run the same command in "
                               "every process)")
        mesh.add_argument("--num-processes", type=int, default=None,
                          help="multi-process pod: total process count")
        mesh.add_argument("--process-id", type=int, default=None,
                          help="multi-process pod: this process's rank "
                               "(0 owns snapshots/plots/results)")
        mesh.add_argument("--fleet-reduce", default=None,
                          choices=("f32", "bf16", "int8"),
                          help="the gradient all-reduce's wire tier for "
                               "meshed ticks: f32 (exact, default), bf16 "
                               "(half the bytes) or int8 (quantized with "
                               "per-leaf scales, ~4x fewer bytes)")
        observe = parser.add_argument_group(
            "observability", "span tracing and the profiler window")
        observe.add_argument("--trace-events", default=None,
                             metavar="PATH",
                             help="turn tracing on and append the span "
                                  "events to this JSONL file (export "
                                  "with `observe export-trace`)")
        observe.add_argument("--profile", default=None, metavar="DIR",
                             help="run inside the torch.profiler window "
                                  "and write its Chrome trace into DIR")
        serve = parser.add_argument_group(
            "serving survival", "admission control, deadlines and chaos "
            "for the serving tier (they write root.common.serve)")
        serve.add_argument("--serve-max-queue", type=int, default=None,
                           metavar="N", help="bound on staged + "
                           "in-flight serving requests (0 disables it)")
        serve.add_argument("--serve-deadline", type=float, default=None,
                           metavar="S", help="default per-request "
                           "serving deadline in seconds")
        serve.add_argument("--serve-paged", action="store_true",
                           default=None, help="serve from the paged KV "
                           "pool instead of the dense slot slab")
        serve.add_argument("--serve-page-size", type=int, default=None,
                           metavar="N", help="positions per KV page")
        serve.add_argument("--serve-pool-pages", type=int, default=None,
                           metavar="N", help="total pages in the KV pool")
        serve.add_argument("--serve-slo", default=None,
                           metavar="OBJ=TARGET[,...]",
                           help="SLO objectives, e.g. ttft_p95_ms=250,"
                           "tpot_p95_ms=50,availability=0.999 (writes "
                           "root.common.observe.slo)")
        serve.add_argument("--serve-history", default=None,
                           metavar="KEY=VALUE[,...]",
                           help="metric history knobs (interval_s, "
                           "capacity, series_cap, seed_rules, "
                           "incident_cooldown_s) or 'off' (writes "
                           "root.common.observe.history)")
        serve.add_argument("--serve-governor", default=None,
                           metavar="KEY=VALUE[,...]",
                           help="the closed-loop serving governor: "
                           "SLO-burn-driven degradation down the "
                           "bf16->int8->int8-kv ladder, admission resize "
                           "and Retry-After priced from the KV pool, a "
                           "proactive breaker guard, e.g. demote_burn=2,"
                           "recover_burn=1,cooldown_s=10,ladder=int8+"
                           "int8-kv (writes root.common.serve.governor)")
        serve.add_argument("--serve-aot", default=None, metavar="PATH",
                           help="boot serving from an AOT bundle (python "
                           "-m veles_tpu_torch aot build): its kernel "
                           "libraries load instead of nvcc building them; "
                           "a stale or tampered bundle is refused with "
                           "the field named and serving boots live "
                           "(writes root.common.serve.aot)")
        serve.add_argument("--serve-mesh", default=None,
                           metavar="AXIS=N[,AXIS=N...]",
                           help="serve tensor-parallel over a mesh, e.g. "
                           "model=2: a world of one process per device "
                           "(--coordinator/--num-processes/--process-id); "
                           "rank 0 serves, the others follow (writes "
                           "root.common.serve.mesh)")
        serve.add_argument("--chaos-serve-seed", type=int, default=None,
                           metavar="N", help="serving chaos RNG seed")
        serve.add_argument("--chaos-serve-step-fail", type=float,
                           default=None, metavar="P",
                           help="inject a decoder-step failure with "
                           "probability P")
        serve.add_argument("--chaos-serve-step-fail-max", type=int,
                           default=None, metavar="N",
                           help="cap on injected step failures")
        serve.add_argument("--chaos-serve-slow-step", type=float,
                           default=None, metavar="P",
                           help="stretch a decode step with "
                           "probability P")
        fleet = parser.add_argument_group(
            "fleet", "master/slave data parallelism over the fleet wire "
            "(fleet/)")
        fleet.add_argument("-l", "--listen", default=None,
                           metavar="HOST:PORT",
                           help="run as the fleet master on this address")
        fleet.add_argument("-m", "--master-address", default=None,
                           metavar="HOST:PORT",
                           help="run as a fleet slave of this master")
        fleet.add_argument("-n", "--nodes", action="append", default=None,
                           metavar="HOST[,HOST...]",
                           help="master: spawn a slave on each host "
                                "(localhost: a local process; yarn://RM "
                                "expands to the cluster's nodes)")
        fleet.add_argument("--respawn", action="store_true",
                           help="relaunch dead slaves on their hosts")
        fleet.add_argument("--slave-death-probability", type=float,
                           default=None, metavar="P",
                           help="fault injection: a slave dies mid-job "
                                "with probability P")
        fleet.add_argument("--async-slave", action="store_true",
                           help="slave: request the next job before the "
                                "update is acknowledged")
        fleet.add_argument("--fleet-plane", default=None,
                           choices=("data", "control"),
                           help="the wire plane: data (weights ride "
                                "every job) or control (weights in the "
                                "handshake and at epoch fences)")
        for flag, kind, what in (
                ("--chaos-seed", int, "the chaos RNG seed"),
                ("--chaos-frame-drop", float, "drop a frame"),
                ("--chaos-frame-delay", float, "delay a frame"),
                ("--chaos-slow-job", float, "stretch a job"),
                ("--chaos-duplicate-update", float,
                 "replay an update"),
                ("--chaos-death", float, "die mid-job")):
            fleet.add_argument(
                flag, type=kind, default=None,
                metavar="N" if kind is int else "P",
                help=what if kind is int
                else "slave chaos: %s with probability P" % what)
        parser.add_argument("-b", "--background", action="store_true",
                            help="daemonize: re-run this command detached, "
                                 "its output in <cache>/daemon.log")
        meta = parser.add_argument_group(
            "meta-workflows", "the GA search and the ensembles: every "
            "evaluation or instance a child run of this command, with "
            "--device passed through")
        meta.add_argument("--optimize", default=None,
                          metavar="SIZE:GENERATIONS",
                          help="GA over the config's Range() values")
        meta.add_argument("--optimize-fleet", default=None,
                          metavar="HOST:PORT",
                          help="serve --optimize's evaluations to fleet "
                               "slaves from a task farm at this address")
        meta.add_argument("--optimize-representation", default="numeric",
                          choices=("numeric", "gray"),
                          help="chromosome representation for --optimize")
        meta.add_argument("--ensemble-train", default=None,
                          metavar="N:RATIO",
                          help="train N instances on RATIO of the train "
                               "set into ensemble.json")
        meta.add_argument("--ensemble-test", default=None, metavar="FILE",
                          help="evaluate an ensemble file's snapshots")
        deferred = parser.add_argument_group(
            "not ported yet", "these parse as in the JAX package, then "
            "exit with code 2 naming the ROADMAP item that brings them")
        for flags, kwargs in (
                (("--serve-paged-kernel",), {"metavar": "on|off"}),
                (("--manhole",), {"action": "store_true"})):
            kwargs.setdefault("default", None)
            deferred.add_argument(*flags, **kwargs)
        return parser

    # -- config handling (reference __main__.py:426-481) ---------------------
    @staticmethod
    def apply_config(config_path):
        if config_path in (None, "-"):
            return
        runpy.run_path(config_path, init_globals={"root": root})

    @staticmethod
    def override_config(overrides):
        import ast
        for item in overrides:
            if "=" not in item:
                raise ValueError("override %r is not root.path=value" % item)
            path, value = item.split("=", 1)
            parts = path.split(".")
            if parts[0] != "root":
                raise ValueError("override must start with 'root.': %r"
                                 % item)
            node = root
            for part in parts[1:-1]:
                node = getattr(node, part)
            try:
                value = ast.literal_eval(value)
            except (ValueError, SyntaxError):
                pass  # keep as string
            setattr(node, parts[-1], value)

    @staticmethod
    def seed_random(spec):
        """Seed the named streams (reference ``_seed_random``,
        ``__main__.py:483-537``): ``N`` seeds "default" with N and
        "loader" with N + 1; ``key=N,key=N`` seeds each stream named."""
        if spec is None:
            return
        if "=" in spec:
            for part in spec.split(","):
                key, _, value = part.partition("=")
                prng.get(key).seed(int(value))
        else:
            prng.get("default").seed(int(spec))
            prng.get("loader").seed(int(spec) + 1)

    # -- workflow module loading (reference _load_model) ---------------------
    @staticmethod
    def load_module(path):
        name = os.path.splitext(os.path.basename(path))[0]
        spec = importlib.util.spec_from_file_location(name, path)
        if spec is None:
            raise ImportError("cannot import workflow from %r" % path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
        if not hasattr(module, "run"):
            raise ValueError(
                "workflow module %s lacks run(load, main)" % path)
        return module

    def _resolve_snapshot(self, path):
        """``-w http(s)://...``: download to a temporary file first
        (reference ``__main__.py:572-581``)."""
        if not path or not path.startswith(("http://", "https://")):
            return path
        import shutil
        import tempfile
        import urllib.request
        suffix = os.path.splitext(path)[1] or ".pickle"
        fd, local = tempfile.mkstemp(suffix=suffix, prefix="snapshot_")
        self.info("downloading snapshot %s", path)
        try:
            with urllib.request.urlopen(path, timeout=60) as resp, \
                    os.fdopen(fd, "wb") as fout:
                shutil.copyfileobj(resp, fout)  # stream, don't buffer
        except Exception:
            try:
                os.unlink(local)
            except OSError:
                pass
            raise
        return local

    # -- the load/main pair handed to the module -----------------------------
    def _load(self, workflow_class, **kwargs):
        if self.snapshot_path:
            from veles_tpu_torch.snapshotter import (SnapshotterToDB,
                                                     SnapshotterToFile)
            self.info("resuming from %s", self.snapshot_path)
            store = (SnapshotterToDB
                     if self.snapshot_path.startswith("sqlite://")
                     else SnapshotterToFile)
            self.workflow = store.import_(self.snapshot_path,
                                          device=self.device)
            self.workflow.workflow = self.launcher
            return self.workflow, True
        kwargs.setdefault("device", self.device)
        self.workflow = workflow_class(self.launcher, **kwargs)
        return self.workflow, False

    def _main(self, **kwargs):
        if self.dry_run == "load":
            return
        self.launcher.initialize(**kwargs)
        if self.visualize:
            with open(self.visualize, "w") as fout:
                fout.write(self.workflow.generate_graph())
            self.info("workflow graph written to %s (render with "
                      "`dot -Tsvg`)", self.visualize)
        if self.dump_unit_attributes:
            self._dump_unit_attributes()
        if self.dry_run == "init":
            return
        if self.profile_dir:
            from veles_tpu_torch.observe.profile import profile_window
            self.info("profiling to %s (open the trace in "
                      "ui.perfetto.dev)", self.profile_dir)
            with profile_window(self.profile_dir):
                self.launcher.run()
        else:
            self.launcher.run()
        self.launcher.stop()

    def _dump_unit_attributes(self):
        """Post-init unit state dump (reference ``--dump-unit-attributes``,
        ``__main__.py:663-685``)."""
        for unit in self.workflow.units:
            attrs = {}
            for key, value in sorted(vars(unit).items()):
                if key.startswith("_") or key.endswith("_"):
                    continue
                if isinstance(value, (int, float, str, bool, type(None))):
                    attrs[key] = value
                elif isinstance(value, (list, tuple)) and len(value) < 16:
                    attrs[key] = repr(value)
                else:
                    attrs[key] = type(value).__name__
            print(json.dumps({"unit": unit.name,
                              "type": type(unit).__name__,
                              "attrs": attrs}))

    # -- entry ----------------------------------------------------------------
    def run(self, argv=None):
        parser = self.init_parser()
        args = parser.parse_args(argv)
        for dest, item in DEFERRED.items():
            if getattr(args, dest) not in (None, False):
                parser.error("--%s is not ported yet: %s"
                             % (dest.replace("_", "-"), item))
        setup_logging(level=logging.DEBUG if args.verbose
                      else logging.INFO)
        # a black box on SIGTERM: an orchestrator killing this run leaves
        # the last spans and dispatches on disk (CLI runs only; library
        # embedders keep their own signal policy)
        from veles_tpu_torch.observe.flight import install_signal_handlers
        install_signal_handlers()
        if args.coordinator and (args.num_processes is None
                                 or args.process_id is None):
            parser.error("--coordinator requires --num-processes and "
                         "--process-id")
        self.joined = False
        try:
            return self._run(parser, args)
        finally:
            if self.joined:
                from veles_tpu_torch.parallel.mesh import (
                    finalize_distributed)
                finalize_distributed()

    def _join(self, args):
        """Join the world (``--coordinator``) after the config layering,
        so ``root.common.mesh.backend`` may name the backend."""
        from veles_tpu_torch.parallel.mesh import initialize_distributed
        self.info("joining the world: coordinator %s, process %d/%d",
                  args.coordinator, args.process_id, args.num_processes)
        initialize_distributed(args.coordinator, args.num_processes,
                               args.process_id, device=args.device)
        self.joined = True

    def _run(self, parser, args):
        if args.trace_events:
            from veles_tpu_torch.core.logger import enable_event_recording
            from veles_tpu_torch.observe.tracing import get_tracer
            enable_event_recording(args.trace_events)
            get_tracer().enable()
            self.info("span tracing to %s", args.trace_events)
        self.profile_dir = args.profile
        # plugins BEFORE the workflow module: a plugin registers its units
        # and loaders by name for the workflow being loaded
        import veles_tpu_torch
        plugins = veles_tpu_torch.scan_plugins()
        if plugins:
            self.info("plugins: %s",
                      ", ".join(getattr(p, "__name__", repr(p))
                                for p in plugins))
        self.device = args.device
        self.dry_run = args.dry_run
        self.snapshot_path = self._resolve_snapshot(args.snapshot)
        self.visualize = args.visualize
        self.dump_unit_attributes = args.dump_unit_attributes
        # module FIRST, then the config file, then the overrides
        module = self.load_module(args.workflow)
        self.apply_config(args.config)
        self.override_config(args.overrides)
        if args.mesh:
            # after the config layering: the flag wins over config files
            from veles_tpu_torch.parallel.mesh import parse_axes
            try:
                overrides = parse_axes(args.mesh, flag="--mesh")
            except ValueError as exc:
                parser.error(str(exc))
            for axis, size in overrides.items():
                setattr(root.common.mesh.axes, axis, size)
        # the observe flags are validated NOW (``__main__.py:543-570``):
        # the strings land in root.common.observe and .serve below, and
        # the SLO engine, the governor and the history parse them again
        # when a front starts
        from veles_tpu_torch.observe.governor import parse_governor_spec
        from veles_tpu_torch.observe.history import parse_history_spec
        from veles_tpu_torch.observe.slo import parse_objectives
        from veles_tpu_torch.parallel.mesh import parse_axes
        for flag, parse in (("serve_slo", parse_objectives),
                            ("serve_governor", parse_governor_spec),
                            ("serve_history", parse_history_spec),
                            ("serve_mesh", parse_axes)):
            value = getattr(args, flag)
            if value:
                try:
                    parse(value, flag="--" + flag.replace("_", "-"))
                except ValueError as exc:
                    parser.error(str(exc))
        # the serving flags AFTER the config layering: the CLI wins
        for flag, node, key in (
                ("serve_max_queue", root.common.serve, "max_queue"),
                ("serve_deadline", root.common.serve, "deadline"),
                ("serve_mesh", root.common.serve, "mesh"),
                ("serve_paged", root.common.serve, "paged"),
                ("serve_page_size", root.common.serve, "page_size"),
                ("serve_pool_pages", root.common.serve, "pool_pages"),
                ("serve_slo", root.common.observe, "slo"),
                ("serve_governor", root.common.serve, "governor"),
                ("serve_aot", root.common.serve, "aot"),
                ("serve_history", root.common.observe, "history"),
                ("fleet_reduce", root.common.fleet, "reduce"),
                ("chaos_serve_seed", root.common.serve.chaos, "seed"),
                ("chaos_serve_step_fail", root.common.serve.chaos,
                 "step_fail"),
                ("chaos_serve_step_fail_max", root.common.serve.chaos,
                 "step_fail_max"),
                ("chaos_serve_slow_step", root.common.serve.chaos,
                 "slow_step")):
            value = getattr(args, flag)
            if value is not None:
                setattr(node, key, value)
        # the fleet flags, same layering rule (``__main__.py:583-606``)
        for flag, key in (("chaos_seed", "seed"),
                          ("chaos_frame_drop", "frame_drop"),
                          ("chaos_frame_delay", "frame_delay"),
                          ("chaos_slow_job", "slow_job"),
                          ("chaos_duplicate_update", "duplicate_update"),
                          ("chaos_death", "death")):
            value = getattr(args, flag)
            if value is not None:
                setattr(root.common.fleet.chaos, key, value)
        if args.fleet_plane is not None:
            root.common.fleet.plane = args.fleet_plane
        if args.background:
            # after the config layering: daemon.log honours a cache dir
            # set by the config file or the overrides
            self._daemonize()
        if args.dump_config:
            root.print_()
            return 0
        if args.coordinator:
            self._join(args)
        if args.train_ratio is not None:
            root.common.train_ratio = args.train_ratio
        self.seed_random(args.seed)
        # the meta-workflows (reference _run_core, __main__.py:716-734),
        # after the seeding: the GA's and the ensemble's host streams
        # replay from --seed (key=N names them), where the JAX package
        # draws them unseeded
        if args.optimize:
            return self._run_optimize(args)
        if args.ensemble_train:
            return self._run_ensemble_train(args)
        if args.ensemble_test:
            return self._run_ensemble_test(args)
        from veles_tpu_torch.genetics.config import fix_config
        fix_config(root)  # a normal run serves every Range's default
        self.launcher = Launcher(
            listen_address=args.listen,
            master_address=args.master_address,
            result_file=args.result_file,
            async_slave=args.async_slave,
            respawn=args.respawn,
            nodes=[h for spec in (args.nodes or [])
                   for h in spec.split(",") if h],
            slave_death_probability=args.slave_death_probability or 0.0)
        module.run(self._load, self._main)
        return 0

    # -- the meta-workflows (veles_tpu/__main__.py:651-690) -----------------
    def _run_optimize(self, args):
        from veles_tpu_torch.genetics import (GeneticsOptimizer,
                                              process_config)
        size, _, gens = args.optimize.partition(":")
        genes = process_config(root)
        if not genes:
            self.error("no Range() values found in the config: nothing "
                       "to optimize")
            return 1
        self.info("optimizing %d genes: %s", len(genes),
                  [path for path, _ in genes])
        optimizer = GeneticsOptimizer(
            args.workflow, args.config, genes=genes,
            population_size=int(size or 12),
            generations=int(gens or 5), seed=args.seed,
            overrides=args.overrides, fleet=args.optimize_fleet,
            representation=args.optimize_representation,
            device=args.device)
        best = optimizer.run()
        if best is None:
            return 1
        print(json.dumps({
            "best_fitness": best.fitness,
            "best_values": {path: value for (path, _), value in
                            zip(best.genes, best.values)},
            "history": optimizer.best_fitness_history,
            "populations": optimizer.populations}, indent=1))
        return 0

    def _run_ensemble_train(self, args):
        from veles_tpu_torch.ensemble import EnsembleTrainer
        count, _, ratio = args.ensemble_train.partition(":")
        trainer = EnsembleTrainer(
            args.workflow, args.config, instances=int(count),
            train_ratio=float(ratio or 0.8), overrides=args.overrides,
            device=args.device)
        trainer.run()
        return 0

    def _run_ensemble_test(self, args):
        from veles_tpu_torch.ensemble import EnsembleTester
        tester = EnsembleTester(args.ensemble_test, args.workflow,
                                args.config, overrides=args.overrides,
                                device=args.device)
        print(json.dumps(tester.run(), indent=1, default=str))
        return 0

    def _daemonize(self):
        """Detach by re-exec (``__main__.py:299-319``): a fresh process
        of the same command without ``-b``, its stdio in
        ``<cache>/daemon.log``; this one exits."""
        import subprocess
        log_path = os.path.join(root.common.dirs.get("cache", "."),
                                "daemon.log")
        os.makedirs(os.path.dirname(log_path) or ".", exist_ok=True)
        argv = [a for a in sys.argv[1:]
                if a not in ("-b", "--background")]
        with open(log_path, "ab") as log, \
                open(os.devnull, "rb") as devnull:
            proc = subprocess.Popen(
                [sys.executable, "-m", "veles_tpu_torch"] + argv,
                stdin=devnull, stdout=log, stderr=log,
                start_new_session=True)
        self.info("daemonized as pid %d, logging to %s", proc.pid,
                  log_path)
        os._exit(0)


def _parity(argv):
    from veles_tpu_torch.parity import main as parity_main
    return parity_main(argv)


def _autotune(argv):
    from veles_tpu_torch.ops.gemm import autotune_main
    return autotune_main(argv)


def _aot(argv):
    from veles_tpu_torch.aot.cli import main as aot_main
    return aot_main(argv)


def _observe(argv):
    from veles_tpu_torch.observe.trace_export import main as observe_main
    return observe_main(argv)


def _forge(argv):
    from veles_tpu_torch.forge.client import main as forge_main
    return forge_main(argv)


def _route(argv):
    from veles_tpu_torch.router import main as route_main
    return route_main(argv)


def _deploy(argv):
    from veles_tpu_torch.deploy_cli import main as deploy_main
    return deploy_main(argv)


#: the JAX package's subcommands the port has -> their entry
COMMANDS = {"parity": _parity, "autotune": _autotune, "aot": _aot,
            "observe": _observe, "forge": _forge, "route": _route,
            "deploy": _deploy}


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in COMMANDS:
        return COMMANDS[argv[0]](argv[1:])
    if argv and argv[0] in DEFERRED_COMMANDS:
        sys.stderr.write("veles_tpu_torch: the %r command is not ported "
                         "yet: %s\n" % (argv[0], DEFERRED_COMMANDS[argv[0]]))
        return 2
    return Main().run(argv)


if __name__ == "__main__":
    sys.exit(main())

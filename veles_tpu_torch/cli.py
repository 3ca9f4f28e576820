"""Programmatic launch API: the callable module's backend.

The port of ``veles_tpu/cli.py`` (reference ``veles/__init__.py:126-189``,
``VelesModule.__call__``): ``import veles_tpu_torch;
veles_tpu_torch("wf.py", "wf_config.py", seed=42, device="cpu")`` runs
what the ``python -m veles_tpu_torch`` command line runs, with keyword
arguments mirroring the CLI flags (underscores for dashes).
``subprocess=True`` starts the run in a ``multiprocessing`` process
(spawned) and returns it at once."""


def kwargs_to_argv(workflow_file, config_file=None, overrides=(),
                   **kwargs):
    """Translate call keyword arguments into the equivalent CLI argv. A
    bool flag is given when True; a list or tuple repeats the flag once
    per element."""
    argv = [str(workflow_file), str(config_file or "-")]
    argv.extend(overrides)
    for key, value in kwargs.items():
        flag = "--" + key.replace("_", "-")
        if isinstance(value, bool):
            if value:
                argv.append(flag)
        elif isinstance(value, (list, tuple)):
            for item in value:
                argv.extend((flag, str(item)))
        elif value is not None:
            argv.extend((flag, str(value)))
    return argv


def run_workflow_file(workflow_file, config_file=None, **kwargs):
    """Run a workflow file; returns the Launcher (or the started process
    with ``subprocess=True``). Raises RuntimeError on a non-zero exit."""
    if kwargs.pop("subprocess", False):
        import multiprocessing
        proc = multiprocessing.get_context("spawn").Process(
            target=run_workflow_file, name="veles_tpu_torch.__call__",
            args=(workflow_file, config_file), kwargs=kwargs)
        proc.start()
        return proc
    from veles_tpu_torch.__main__ import Main
    main = Main()
    rc = main.run(kwargs_to_argv(workflow_file, config_file, **kwargs))
    if rc:
        raise RuntimeError("workflow run failed with exit code %s" % rc)
    return main.launcher

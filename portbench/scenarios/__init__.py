"""Scenarios: what one shape of deployment brings to the harness, a file
each, found by name.

A configuration file names its scenario under the key ``"scenario"``; a
file without the key is a ``tor`` configuration.  The harness loads
``portbench/scenarios/<name>.py`` (``cell.scenario``) and asks it for
every part of a run that depends on the deployment's shape; the queue of
episodes, the window, the readings, the readers and the result stay the
harness's own.  A scenario file provides:

``KERNELS``
    ``{mode: names}``: the program's kernels (``shadow_tpu_torch/ops``
    libraries) that a cell whose mix has that ``mode`` (``serial`` or
    ``fleet``) launches; on a card they are built and loaded before the
    warm-up, so that no episode builds one.
``PARTS``
    The kinds of answer :func:`check` counts, in the order printed.
``TINY_CONFIG``, ``TINY_TRAFFIC``
    The keys the CPU tests overwrite in a configuration file of this
    scenario and in the mix of its cells, to cut them to a size the CPU
    runs in seconds.
``configuration(config, traffic, stoptime, draw_seed)``
    The program's ``Configuration`` of one episode, from the parsed
    configuration and mix files, the episode's stoptime in seconds and
    the episode's seed for the scenario's own draws.
``options(config, traffic, *, seed, stoptime, device, chips, control)``
    The program's ``Options`` of that episode: the engine's seed, the
    stoptime, the device the run is on (``cuda``, or ``cpu`` for the
    tests), the number of cards the cell asks for, and whether the run is
    the control (``--control 1``): the program on a path that the check
    has to refuse.
``warm_stoptime(config, traffic)``
    The stoptime of the warm-up episode, which runs every shape the
    cell's episodes launch and is counted as set-up.
``record(ctl)``
    From a ``Controller`` whose run has ended: the episode's answers and
    whatever a metric reads, as arrays and numbers that hold none of the
    program's objects.  The harness adds ``index``, ``engine_seed``,
    ``draw_seed``, ``sim_s`` (the stoptime), ``rc`` (the run's exit
    code), ``t_start``, ``t_loop`` (the engine loop's start) and
    ``t_end``.
``check(rec, config, traffic, device)``
    The episode held to the scenario's plain reference on ``device``,
    once the window has closed: ``(off, ref)``, the answers that differ
    from the reference's by kind (the keys of ``PARTS``) and the
    reference's outcome, kept as ``rec["ref"]`` for the metrics' readers.

A scenario imports nothing of JAX or of the JAX package ``shadow_tpu``.
It imports the port (``shadow_tpu_torch``) inside its functions, never
when it is loaded; its reference, a module of ``portbench/`` (the Tor
scenario's is ``portbench/reference.py``), imports nothing of the port.
"""

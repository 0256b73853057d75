"""One module a driven entry point, named by a configuration's ``driver``.

A driver module has a ``Driver(torch, config, traffic, seed, device,
spans)``, which makes the run's inputs with the mix's generator and reads
its settings from the configuration and the mix, with:

- ``job(seed)``: one call into the program, a
  :class:`kubench.harness.jobs.Job`, whose ``peak`` names the precision
  its operations are counted at;
- ``mark()``: the program's counters at the window's start;
- ``summary(jobs)``: (what the counters say of the window, printed; the
  number of launches the program made otherwise than it plans or than
  the jobs recorded, which has to be 0);
- ``check(job)``: (the numbers that decide ``correct``, from the
  reference, each with a limit of that name in the configuration's
  ``limits``; diagnostics that are printed and not compared);
- ``control(seed)``: the reference in the program's place, in the next
  precision down.

and, beside the class, ``FAULTS`` (the faults a cell can have, by name)
and ``fault(name)``, a context that plants one in the program, for
``kubench/calibrate.py`` and the tests.
"""

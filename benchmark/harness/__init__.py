"""The benchmark's general code: the spec and its files (``spec``), the
traffic generator (``traffic``), the worlds both sides get (``world``),
the timed loops (``loops``), the trace (``trace``), the check that
decides ``correct`` (``check``) and the run itself (``main``)."""

"""Runtime clock sanitizer (``clocksan``, a copy of the reference's;
``REPRO_CLOCKSAN=1`` turns it on).  The static linter stays with the
reference package."""

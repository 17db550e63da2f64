"""Runtime clock sanitizer (``clocksan``, a copy of the reference's;
``REPRO_CLOCKSAN=1`` turns it on) and the lint report schema
(``report``, a copy of the reference's, used by the scenario lint's
``--format json``).  The static linter stays with the reference
package."""

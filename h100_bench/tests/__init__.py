"""CPU tests of the benchmark; the tests that need a card carry the
``cuda`` marker and skip without one."""

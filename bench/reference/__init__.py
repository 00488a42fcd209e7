"""Plain references of the configurations, one module per family, named
by a configuration file's `reference` key. They import nothing of the
program under test."""

"""The benchmark's general code: finding a cell's files by name, the
chip checks, the training driver, the reduction of a device trace and the
cost model of the work.  Whatever belongs to one configuration, traffic
mix, cell or metric lives in a file of its own under ``gbdt_bench/``."""

"""Many packing problems in one launch: the multi-solve on one card
(``sharding.sharded_multi_solve``)."""

"""Runtime: the logical-axis sharding policy and the train step."""

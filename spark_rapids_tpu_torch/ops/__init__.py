"""Stateless columnar ops: Spark row hashes, JCUDF row conversion, the
fixed-capacity device join probe, GROUP BY and ORDER BY over columns and
the copying, aggregation and key helpers they stand on."""

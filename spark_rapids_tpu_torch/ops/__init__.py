"""Stateless columnar ops: Spark row hashes, JCUDF row conversion and
the fixed-capacity device join probe."""

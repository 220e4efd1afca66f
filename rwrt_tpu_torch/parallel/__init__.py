"""Ray-axis device mesh (``sharding.py``)."""

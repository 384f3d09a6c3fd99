"""The yardstick's work counts and the card's peaks (see ``work.py``)."""

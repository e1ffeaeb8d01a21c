"""The plain reference that decides `correct` (check.py) and the frozen
copy of the port it runs (plain/)."""

"""The block of each published architecture, one module a ``model_type``:
``forms/<model_type>.py``, found by ``modelspec.load_form``.  A form
declares what ``load_form``'s docstring lists; a new architecture is a new
form, a config file and cells, with no edit to the harness.  Modules whose
names start with ``_`` are pieces that forms share, not forms.
"""

"""Capture formats: each module makes captures and decodes them plainly."""

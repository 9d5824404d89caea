"""Launchers: the serving and training entry points and their step builders."""

"""The plain reference the check compares against (torch only)."""

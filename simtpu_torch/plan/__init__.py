"""The capacity planner (`capacity`): the `apply` path."""

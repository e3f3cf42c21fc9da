"""DeepRecInfra pieces the serving path needs: the query generator and the
scheduler's knob ladders.  numpy only."""
